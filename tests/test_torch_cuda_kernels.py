"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without them each skips. The
module imports no JAX, so it also runs on a machine that has none:

    pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the row writes (paged and dense) copy values, or quantize them
with the plain version's IEEE arithmetic, and must be bit-identical; the
attention kernels (paged decode and verify, dense decode and verify)
accumulate in float32 like their plain versions, in another order, so
float32 outputs agree within 1e-5 and bf16 outputs within 2e-2 (one bf16
ulp of outputs below 4 in magnitude is at most 2^-6), over bf16/f32 pools
and int8 pools alike. K6, the stats form of the dense decode, returns the
float32 flash triple: m and l within 1e-4 relative and acc / l within
1e-4 of the plain version's; merged over 2 and 4 shards it is held to K4
by the tolerances above. The fused q/k prologue and row write: v and,
without the norm, q and k bit-identical to the plain version; with the
norm (its sum of squares taken in another order) q and k within one bf16
ulp of each head row's largest value (float32: 1e-5 of it), int8 codes
within 1 and scales within 2^-8, bit-identical where the k row is.
"""

import dataclasses

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


def _int8_pools(rng, L, P, hkv, ps, d, dev):
    """Random int8 pools; scales around amax / 127 of standard normal rows
    of 128 values (~0.02), so the dequantized values have the magnitude of
    the float pools above and one float32 tolerance serves both."""
    shape = (L, P, hkv, ps, d)
    return [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-127, 128, shape).astype(np.int8),
        rng.integers(-127, 128, shape).astype(np.int8),
        rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32),
        rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32))]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,ps,d", [(4, 2, 8, 16), (16, 8, 64, 128)])
def test_paged_attention_quant_matches_plain(dev, dtype, tol, hq, hkv, ps, d):
    """The int8 instance: rows of limit 0, one row, page edges, the full
    window; OOB_PAGE table entries past each row's live range."""
    maxp = 4
    rng, _, _, table = _layout(6, 1, hkv, ps, 16, maxp, seed=78)
    pk, pv, ks, vs = _int8_pools(rng, 2, 6 * maxp + 1, hkv, ps, d, dev)
    lengths = np.array([0, 1, ps, ps + 1, maxp * ps, 2 * ps + 3], np.int32)
    for n, lim in enumerate(lengths):
        table[n, max(-(-int(lim) // ps), 1):] = OOB_PAGE
    q = torch.from_numpy(rng.standard_normal((6, hq, d)).astype(
        np.float32)).to(dev, dtype)
    lim = torch.from_numpy(lengths).to(dev)
    tab = torch.from_numpy(table).to(dev)
    before = tpa.launch_counts()
    out = tpa.paged_attention_quant(q, pk, pv, ks, vs, lim, 1, tab)
    after = tpa.launch_counts()
    assert after["paged_attention_quant"] == \
        before["paged_attention_quant"] + 1
    assert after["paged_attention"] == before["paged_attention"]
    ref = tpa.paged_attention_plain(q, pk, pv, lim, 1, tab, ks, vs)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,d", [(2, 16), (8, 128)])
def test_cache_write_quant_bit_identical_to_plain(dev, dtype, hkv, d):
    """Dropped rows (-1, past the window, OOB_PAGE tables), kept rows, a
    zero row (scale floor) and chunk rows sharing one table's pages."""
    maxp, ps = 3, 8
    rng, _, _, table = _layout(8, 1, hkv, ps, 16, maxp, seed=9)
    pools = _int8_pools(rng, 2, 8 * maxp + 1, hkv, ps, d, dev)
    ref = [p.clone() for p in pools]
    table[0, :] = OOB_PAGE
    table[5:] = table[4]
    rows = np.array([-1, 0, 8, 23, maxp * ps, 12, 13, 14], np.int32)
    new = rng.standard_normal((2, 8, hkv, d)).astype(np.float32) \
        * 10.0 ** rng.uniform(-4, 2, (2, 8, hkv, 1))
    new[0, 1, 0] = 0.0
    kn, vn = (torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
              for a in new)
    r, t = torch.from_numpy(rows).to(dev), torch.from_numpy(table).to(dev)
    before = tpa.cache_write_rows_quant_paged.launches
    tpa.cache_write_rows_quant_paged(*pools, kn, vn, r, 1, t)
    assert tpa.cache_write_rows_quant_paged.launches == before + 1
    tpa.cache_write_rows_quant_paged_plain(*ref, kn, vn, r, 1, t)
    torch.cuda.synchronize()
    for got, want in zip(pools, ref):
        assert torch.equal(got, want)


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
    pool8 = pool.to(torch.int8)
    scales = torch.ones(pool.shape[:-1], device=dev)
    with pytest.raises(TypeError):
        tpa.paged_attention_quant(q, pool8, pool8, scales.double(), scales,
                                  lim, 0, tab)
    with pytest.raises(ValueError):
        tpa.paged_attention_quant(q, pool8, pool8, scales[..., :4], scales,
                                  lim, 0, tab)
    with pytest.raises(TypeError):
        tpa.cache_write_rows_quant_paged(pool, pool, scales, scales,
                                         q[:, :2], q[:, :2], lim, 0, tab)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,R", [(4, 2, 5), (16, 8, 5), (16, 2, 4)])
def test_paged_attention_spec_matches_plain(dev, dtype, tol, quant, hq, hkv,
                                            R):
    """K1-spec: R rows per slot as packed rows, G up to 8 with R * G up
    to 32; rows crossing page edges, the window's last rows, OOB_PAGE table
    entries past each slot's lengths + R."""
    ps, d, maxp = 8, 16, 4
    rng, pk, pv, table = _layout(6, 2, hkv, ps, d, maxp, seed=90)
    lengths = np.array([0, 3, 6, 11, 20, maxp * ps - R], np.int32)
    for n, ln in enumerate(lengths):
        table[n, -(-(int(ln) + R) // ps):] = OOB_PAGE
    q = torch.from_numpy(rng.standard_normal((6, R, hq, d)).astype(
        np.float32)).to(dev, dtype)
    lens = torch.from_numpy(lengths).to(dev)
    tab = torch.from_numpy(table).to(dev)
    if quant:
        pk, pv, ks, vs = _int8_pools(rng, 2, 6 * maxp + 1, hkv, ps, d, dev)
        scales = (ks, vs)
        fn, name = tpa.paged_attention_spec_quant, "paged_attention_spec_quant"
    else:
        pk, pv = (torch.from_numpy(a).to(dev, dtype) for a in (pk, pv))
        scales = ()
        fn, name = tpa.paged_attention_spec, "paged_attention_spec"
    before = tpa.launch_counts()
    out = fn(q, pk, pv, *scales, lens, 1, tab)
    after = tpa.launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {k: int(k == name) for k in after}
    ref = tpa.paged_attention_spec_plain(q, pk, pv, lens, 1, tab, *scales)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 16), (16, 8, 128),
                                      (16, 2, 128)])
def test_dense_attention_matches_plain(dev, dtype, tol, hq, hkv, d):
    """K4 (lengths 0, 1, a 64-row tile edge, the full window of 200 rows,
    a partial last tile) and K7 (R = 5 up to the window's last rows)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    B, S, R = 6, 200, 5
    rng = np.random.default_rng(91)
    ck, cv = (torch.from_numpy(rng.standard_normal(
        (2, B, hkv, S, d)).astype(np.float32)).to(dev, dtype)
        for _ in range(2))
    for entry, lengths, rows in (
            (tda.decode_attend_dense, [0, 1, 64, 65, S, 130], 1),
            (tda.spec_attend_dense, [0, 2, 60, 64, S - R, 131], R)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.from_numpy(rng.standard_normal((B, rows, hq, d)).astype(
            np.float32)).to(dev, dtype)
        before = entry.launches
        out = entry(q, ck, cv, lens, 1)
        assert entry.launches == before + 1
        limits = lens if rows == 1 else lens + 1
        ref = tda.dense_attention_plain(q, ck, cv, limits, 1)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        assert (out.float() - ref.float()).abs().max().item() <= tol
        if rows == 1:
            assert not out[0].any()                  # length 0: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_row_write_bit_identical_to_plain(dev, dtype):
    """K8: R = 3 rows per slot, kept rows at the window's edges and dropped
    ones (-1, S, far past S)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    B, S, R, hkv, d = 4, 40, 3, 2, 16
    rng = np.random.default_rng(92)
    ck, cv = (torch.from_numpy(rng.standard_normal(
        (2, B, hkv, S, d)).astype(np.float32)).to(dev, dtype)
        for _ in range(2))
    rows = torch.tensor([[0, 1, 2], [-1, 5, 39], [S, 10**6, 7],
                         [37, 38, 39]], dtype=torch.int32, device=dev)
    kn, vn = (torch.from_numpy(rng.standard_normal(
        (B, R, hkv, d)).astype(np.float32)).to(dev, dtype) for _ in range(2))
    rk, rv, orig = ck.clone(), cv.clone(), ck.clone()
    before = tda.cache_write_rows_dense.launches
    tda.cache_write_rows_dense(ck, cv, kn, vn, rows, 1)
    assert tda.cache_write_rows_dense.launches == before + 1
    tda.cache_write_rows_dense_plain(rk, rv, kn, vn, rows, 1)
    torch.cuda.synchronize()
    assert torch.equal(ck, rk) and torch.equal(cv, rv)
    assert not torch.equal(ck, orig)


def test_spec_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    pool = torch.zeros((1, 3, 2, 8, 16), device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    tab = torch.ones((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bad shapes"):     # G = 9
        tpa.paged_attention_spec(torch.zeros((2, 5, 18, 16), device=dev),
                                 pool, pool, lens, 0, tab)
    cache = torch.zeros((1, 2, 2, 8, 16), device=dev)
    with pytest.raises(TypeError):
        tda.spec_attend_dense(torch.zeros((2, 3, 4, 16), device=dev),
                              cache.bfloat16(), cache.bfloat16(), lens, 0)
    with pytest.raises(ValueError):
        tda.decode_attend_dense(torch.zeros((3, 1, 4, 16), device=dev),
                                cache, cache, lens, 0)
    with pytest.raises(ValueError):
        tda.cache_write_rows_dense(cache, cache,
                                   torch.zeros((2, 1, 2, 16), device=dev),
                                   torch.zeros((2, 1, 2, 16), device=dev),
                                   lens, 0)


# -- the window instances (window > 0) ----------------------------------------


def _window_case(rng, hkv, ps, d, dev, dtype, quant, n_slots, maxp):
    """A pool (float, or int8 with scales) of n_slots * maxp pages plus a
    spare page for the poison cases, and a shuffled table."""
    P = n_slots * maxp + 2
    table = (rng.permutation(n_slots * maxp) + 1).reshape(
        n_slots, maxp).astype(np.int32)
    if quant:
        return _int8_pools(rng, 2, P, hkv, ps, d, dev), table
    return [torch.from_numpy(rng.standard_normal((2, P, hkv, ps, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(2)], table


def _lo_hi(limits, ps, maxp, window):
    lo, hi = tpa._live_pages(torch.from_numpy(limits), ps, maxp, window)
    return lo.numpy(), hi.numpy()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,ps,d,window", [(4, 2, 8, 16, 12),
                                                (32, 8, 64, 128, 200)])
def test_paged_attention_window_matches_plain(dev, dtype, tol, quant, hq,
                                              hkv, ps, d, window):
    """K1's window instance, decode and ragged rows: limit 0, rows below,
    at and past the window, window starts mid-page; OOB_PAGE entries past
    each row's last page and below its first."""
    maxp = 6
    rng = np.random.default_rng(95)
    pools, table = _window_case(rng, hkv, ps, d, dev, dtype, quant, 8, maxp)
    limits = np.array([0, 1, window, window + 1, window + 2 * ps + 3,
                       maxp * ps - 5, maxp * ps, 2 * ps], np.int32)
    lo, hi = _lo_hi(limits, ps, maxp, window)
    for n in range(len(limits)):
        table[n, :lo[n]] = OOB_PAGE
        table[n, hi[n] + 1:] = OOB_PAGE
    q = torch.from_numpy(rng.standard_normal((8, hq, d)).astype(
        np.float32)).to(dev, dtype)
    lim = torch.from_numpy(limits).to(dev)
    tab = torch.from_numpy(table).to(dev)
    fn = tpa.paged_attention_quant if quant else tpa.paged_attention
    before = tpa.launch_counts()
    out = fn(q, *pools, lim, 1, tab, window=window)
    after = tpa.launch_counts()
    assert after[fn.__name__ + " window"] == \
        before[fn.__name__ + " window"] + 1
    pk, pv, *scales = pools
    ref = tpa.paged_attention_plain(q, pk, pv, lim, 1, tab, *scales,
                                    window=window)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    full = tpa.paged_attention_plain(q, pk, pv, lim, 1, tab, *scales)
    assert (full.float() - ref.float()).abs().max().item() > 0.05


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,ps,d,window", [(4, 2, 8, 16, 12),
                                                (32, 8, 64, 128, 200)])
def test_paged_attention_spec_window_matches_plain(dev, dtype, tol, quant,
                                                   hq, hkv, ps, d, window):
    """K1-spec's window instance: R = 5 rows per slot, each from its own
    window start; lengths whose rows move the start across a page edge."""
    maxp, R = 6, 5
    rng = np.random.default_rng(96)
    pools, table = _window_case(rng, hkv, ps, d, dev, dtype, quant, 6, maxp)
    lengths = np.array([0, window - 3, window + ps - 2, 3 * ps + 1,
                        maxp * ps - R - 7, maxp * ps - R], np.int32)
    q = torch.from_numpy(rng.standard_normal((6, R, hq, d)).astype(
        np.float32)).to(dev, dtype)
    lens = torch.from_numpy(lengths).to(dev)
    tab = torch.from_numpy(table).to(dev)
    fn = tpa.paged_attention_spec_quant if quant else tpa.paged_attention_spec
    before = tpa.launch_counts()
    out = fn(q, *pools, lens, 1, tab, window=window)
    after = tpa.launch_counts()
    assert after[fn.__name__ + " window"] == \
        before[fn.__name__ + " window"] + 1
    pk, pv, *scales = pools
    ref = tpa.paged_attention_spec_plain(q, pk, pv, lens, 1, tab, *scales,
                                         window=window)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("entry", ["decode", "spec"])
def test_paged_attention_window_reads_no_page_below_its_start(dev, quant,
                                                              entry):
    """Table entries below each row's window start point at a page of NaN
    (int8: NaN scales). Had the kernel read it, 0 * NaN would reach P.V:
    the output must be finite and bit-identical to the clean table's."""
    hq, hkv, ps, d, window, maxp, R = 32, 8, 64, 128, 200, 6, 5
    rng = np.random.default_rng(97)
    pools, table = _window_case(rng, hkv, ps, d, dev, torch.bfloat16, quant,
                                6, maxp)
    nan = pools[0].shape[1] - 1                    # the spare page
    for t in (pools[2:] if quant else pools):
        t[:, nan] = float("nan")
    rows = 1 if entry == "decode" else R
    lengths = np.array([window + ps, 2 * ps + window - 1, 4 * ps + 9,
                        maxp * ps - R, window + 3 * ps, 5 * ps], np.int32)
    # slot b's first page: its (row 0's) window start's
    lo, _ = _lo_hi(lengths + (rows > 1), ps, maxp, window)
    assert lo.min() >= 1
    bad = table.copy()
    for n in range(len(lengths)):
        bad[n, :lo[n]] = nan
    q = torch.from_numpy(rng.standard_normal((6, rows, hq, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    lens = torch.from_numpy(lengths).to(dev)

    def run(tab):
        tab = torch.from_numpy(tab).to(dev)
        if entry == "decode":
            return tpa.decode_attend_paged(q, pools[0], pools[1], lens, 1,
                                           tab, *pools[2:], window=window)
        return tpa.decode_attend_spec_paged(q, pools[0], pools[1], lens, 1,
                                            tab, *pools[2:], window=window)

    clean, dirty = run(table), run(bad)
    torch.cuda.synchronize()
    assert torch.isfinite(dirty.float()).all()
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,d,window", [(4, 2, 16, 24),
                                             (32, 8, 128, 100)])
def test_dense_attention_window_matches_plain(dev, dtype, tol, hq, hkv, d,
                                              window):
    """K4 and K7's window instance over 64-row tiles: lengths 0 (zeros),
    below, at and past the window, window starts inside a tile; then rows
    below each row's window start's tile set to NaN must change nothing."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    B, S, R = 6, 320, 5
    rng = np.random.default_rng(98)
    ck, cv = (torch.from_numpy(rng.standard_normal(
        (2, B, hkv, S, d)).astype(np.float32)).to(dev, dtype)
        for _ in range(2))
    for entry, lengths, rows in (
            (tda.decode_attend_dense, [0, 1, window, window + 70, S, 250],
             1),
            (tda.spec_attend_dense, [0, window - 2, 130, 200, S - R, 191],
             R)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.from_numpy(rng.standard_normal((B, rows, hq, d)).astype(
            np.float32)).to(dev, dtype)
        before = tda.launch_counts()
        out = entry(q, ck, cv, lens, 1, window)
        after = tda.launch_counts()
        assert after[entry.__name__ + " window"] == \
            before[entry.__name__ + " window"] + 1
        limits = lens if rows == 1 else lens + 1
        ref = tda.dense_attention_plain(q, ck, cv, limits, 1, window)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol
        if rows == 1:
            assert not out[0].any()                  # length 0: zeros
        # the rows below each slot's first tile (row 0's window start's)
        pk, pv = ck.clone(), cv.clone()
        for b, ln in enumerate(lengths):
            start = max(ln + (rows > 1) - window, 0) // 64 * 64
            pk[1, b, :, :start] = float("nan")
            pv[1, b, :, :start] = float("nan")
        dirty = entry(q, pk, pv, lens, 1, window)
        torch.cuda.synchronize()
        assert torch.isfinite(dirty.float()).all()
        assert torch.equal(out, dirty)


# -- the dense engine's kernels: K9, K4-int8, K7-int8, K5 ----------------------


def _dense_cache(rng, B, S, hkv, d, dev, dtype, quant):
    """A dense cache [2, B, hkv, S, d]: float of ``dtype``, or int8 with
    scales as :func:`_int8_pools` draws them; returns [k, v] or
    [k, v, ks, vs]."""
    if quant:
        return _int8_pools(rng, 2, B, hkv, S, d, dev)
    return [torch.from_numpy(rng.standard_normal((2, B, hkv, S, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(2)]


def _dense_call(tda, q, cache, lens, layer, window, bb, rows):
    kw = {"cache_ks": cache[2], "cache_vs": cache[3]} if len(cache) > 2 \
        else {}
    if rows == 1:
        return tda.decode_attend_dense(q, cache[0], cache[1], lens, layer,
                                       window, **kw, bblock=bb)
    return tda.spec_attend_dense(q, cache[0], cache[1], lens, layer, window,
                                 **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,d", [(2, 16), (8, 128)])
def test_dense_quant_row_write_bit_identical_to_plain(dev, dtype, hkv, d):
    """K9: R = 3 rows per slot, kept rows at the window's edges, a zero row
    (scale floor) and dropped ones (-1, S, far past S): int8 rows and
    scales bit for bit."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    B, S, R = 4, 40, 3
    rng = np.random.default_rng(99)
    cache = _dense_cache(rng, B, S, hkv, d, dev, dtype, True)
    ref = [t.clone() for t in cache]
    rows = torch.tensor([[0, 1, 2], [-1, 5, 39], [S, 10**6, 7],
                         [37, 38, 39]], dtype=torch.int32, device=dev)
    new = rng.standard_normal((2, B, R, hkv, d)) \
        * 10.0 ** rng.uniform(-4, 2, (2, B, R, hkv, 1))
    new[0, 0, 1, 0] = 0.0
    kn, vn = (torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
              for a in new)
    before = tda.cache_write_rows_quant_dense.launches
    tda.cache_write_rows_quant_dense(*cache, kn, vn, rows, 1)
    assert tda.cache_write_rows_quant_dense.launches == before + 1
    tda.cache_write_rows_quant_dense_plain(*ref, kn, vn, rows, 1)
    torch.cuda.synchronize()
    for got, want in zip(cache, ref):
        assert torch.equal(got, want)
    assert not torch.equal(cache[2], _dense_cache(
        np.random.default_rng(99), B, S, hkv, d, dev, dtype, True)[2])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 16), (16, 8, 128)])
def test_dense_attention_quant_matches_plain(dev, dtype, tol, hq, hkv, d):
    """K4-int8 (lengths 0, 1, a tile edge, the full window, a partial last
    tile) and K7-int8 (R = 5 up to the window's last rows)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    B, S, R = 6, 200, 5
    rng = np.random.default_rng(100)
    cache = _dense_cache(rng, B, S, hkv, d, dev, dtype, True)
    for entry, lengths, rows in (
            ("decode_attend_dense", [0, 1, 64, 65, S, 130], 1),
            ("spec_attend_dense", [0, 2, 60, 64, S - R, 131], R)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.from_numpy(rng.standard_normal((B, rows, hq, d)).astype(
            np.float32)).to(dev, dtype)
        before = tda.launch_counts()
        out = _dense_call(tda, q, cache, lens, 1, 0, 1, rows)
        after = tda.launch_counts()
        assert after[entry + " quant"] == before[entry + " quant"] + 1
        assert after[entry] == before[entry]
        limits = lens if rows == 1 else lens + 1
        ref = tda.dense_attention_plain(q, cache[0], cache[1], limits, 1, 0,
                                        cache[2], cache[3])
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        assert (out.float() - ref.float()).abs().max().item() <= tol
        if rows == 1:
            assert not out[0].any()                  # length 0: zeros


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bb,window", [(2, 0), (4, 0), (4, 100), (8, 100)])
def test_dense_attention_bblock_matches_plain(dev, dtype, tol, quant, bb,
                                              window):
    """K5 (bb slots per CTA, bf16/f32 and int8, window 0 and 100) over 8
    slots of 16 query heads: blocks mixing long and short slots, a length-0
    slot beside longer ones (ROADMAP C11: zeros, as K4), window starts in
    different tiles of one block."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    hq, hkv, d, S = 16, 8, 128, 320
    lengths = [0, 300, 7, 64, 65, S, 130, 201]
    rng = np.random.default_rng(101 + bb)
    cache = _dense_cache(rng, 8, S, hkv, d, dev, dtype, quant)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal((8, 1, hq, d)).astype(
        np.float32)).to(dev, dtype)
    name = tda.instance_name("decode_attend_dense", quant, bb, window)
    before = tda.launch_counts()
    out = _dense_call(tda, q, cache, lens, 1, window, bb, 1)
    after = tda.launch_counts()
    assert after[name] == before[name] + 1
    assert after["decode_attend_dense"] == before["decode_attend_dense"]
    one = _dense_call(tda, q, cache, lens, 1, window, 1, 1)
    ref = tda.dense_attention_plain(q, cache[0], cache[1], lens, 1, window,
                                    *cache[2:])
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out.float() - one.float()).abs().max().item() <= tol
    assert not out[0].any()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("entry,bb", [("decode", 1), ("spec", 1),
                                      ("decode", 4)])
def test_dense_window_reads_no_row_below_its_first_tile(dev, quant, entry,
                                                        bb):
    """The window instances of K4, K7 (int8 too) and K5: the rows below
    each slot's first tile (K5 too: each slot walks its own tiles) hold
    NaN (int8: NaN scales). Had a kernel read them, 0 * NaN would reach
    P.V: the output must be finite and bit-identical to the clean
    cache's."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    hq, hkv, d, S, window, R = 32, 8, 128, 512, 200, 5
    rows = 1 if entry == "decode" else R
    lengths = np.array([window + 64, 2 * 64 + window - 1, 4 * 64 + 9,
                        S - R, window + 3 * 64, 5 * 64, S - 70, 300],
                       np.int32)
    rng = np.random.default_rng(102)
    cache = _dense_cache(rng, 8, S, hkv, d, dev, torch.bfloat16, quant)
    q = torch.from_numpy(rng.standard_normal((8, rows, hq, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    lens = torch.from_numpy(lengths).to(dev)
    start = (np.maximum(lengths + (rows > 1) - window, 0) // 64 * 64)
    assert start.min() >= 64
    dirty = [t.clone() for t in cache]
    for b, st in enumerate(start):
        for t in (dirty[2:] if quant else dirty):
            t[1, b, :, :st] = float("nan")
    clean = _dense_call(tda, q, cache, lens, 1, window, bb, rows)
    bad = _dense_call(tda, q, dirty, lens, 1, window, bb, rows)
    torch.cuda.synchronize()
    assert torch.isfinite(bad.float()).all()
    assert torch.equal(clean, bad)


# -- K6: the stats form of the dense decode (sequence-parallel serving) -------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 16), (16, 8, 128)])
def test_dense_attention_stats_matches_plain(dev, dtype, quant, hq, hkv, d):
    """K6 over one shard: local lengths 0 (a shard with none of the slot's
    rows: exactly (0, -1e30, 0)), 1, a tile edge, the full shard and a
    partial last tile. m and l within 1e-4 relative and acc / l within
    1e-4 of the plain version's (all float32, summed in another order)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    B, S = 6, 200
    rng = np.random.default_rng(103)
    cache = _dense_cache(rng, B, S, hkv, d, dev,
                         torch.float32 if quant else dtype, quant)
    scales = cache[2:]
    lens = torch.tensor([0, 1, 64, 65, S, 130], dtype=torch.int32,
                        device=dev)
    q = torch.from_numpy(rng.standard_normal((B, 1, hq, d)).astype(
        np.float32)).to(dev, dtype)
    name = tda.instance_name("decode_attend_dense", quant, stats=True)
    before = tda.launch_counts()
    acc, m, l_sum = tda.decode_attend_dense_stats(q, cache[0], cache[1],
                                                  lens, 1, *scales)
    after = tda.launch_counts()
    assert after[name] == before[name] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    racc, rm, rl = tda.dense_attention_stats_plain(q, cache[0], cache[1],
                                                   lens, 1, *scales)
    torch.cuda.synchronize()
    assert acc.shape == (B, hq, d) and m.shape == l_sum.shape == (B, hq)
    assert acc.dtype == m.dtype == l_sum.dtype == torch.float32
    assert (m[0] == -1e30).all() and not l_sum[0].any() and not acc[0].any()
    torch.testing.assert_close(m[1:], rm[1:], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(l_sum[1:], rl[1:], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(acc[1:] / l_sum[1:, :, None],
                               racc[1:] / rl[1:, :, None], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("sp", [2, 4])
def test_dense_attention_stats_merged_matches_k4(dev, dtype, tol, quant, sp):
    """K6 over ``sp`` shards of the cache at their local lengths, merged
    (ops/attention.merge_stats): K4 over the unsharded cache within the
    dense kernels' tolerance, a slot of length 0 zeros."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        merge_stats

    B, S, hq, hkv, d = 6, 256, 16, 8, 128
    s_local = S // sp
    rng = np.random.default_rng(104)
    cache = _dense_cache(rng, B, S, hkv, d, dev,
                         torch.float32 if quant else dtype, quant)
    lengths = np.array([0, 1, s_local, s_local + 1, S - 5, S], np.int32)
    q = torch.from_numpy(rng.standard_normal((B, 1, hq, d)).astype(
        np.float32)).to(dev, dtype)
    parts = []
    for i in range(sp):
        shard = [t[:, :, :, i * s_local:(i + 1) * s_local].contiguous()
                 for t in cache]
        local = torch.from_numpy(np.clip(lengths - i * s_local, 0, s_local)
                                 .astype(np.int32)).to(dev)
        parts.append(tda.decode_attend_dense_stats(q, shard[0], shard[1],
                                                   local, 1, *shard[2:]))
    ctx = merge_stats(*zip(*parts), dev).to(dtype)
    ref = _dense_call(tda, q, cache, torch.from_numpy(lengths).to(dev), 1,
                      0, 1, 1)[:, 0]
    torch.cuda.synchronize()
    assert (ctx.float() - ref.float()).abs().max().item() <= tol
    assert not ctx[0].any()


# -- the split-KV decode: split edges and the combine -------------------------


def _split_edges(n_rows, tile, tiles, splits):
    """Lengths at the split kernels' edges: 0, one column, one tile and one
    past it, the full window, rows whose tiles end exactly on a split
    boundary and one column past them (``n_rows`` of them)."""
    runs = [splits * k * tile for k in range(1, tiles // splits + 1)]
    edges = [0, 1, tile - 1, tile, tile + 1, tiles * tile] + runs \
        + [r + 1 for r in runs]
    return np.resize(np.array(edges, np.int32), n_rows)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 200])
def test_paged_attention_at_split_edges(dev, dtype, tol, quant, window):
    """K1 decode over 32 rows of 8 kv heads (several splits on a card of
    132 SMs): rows of limit 0 (C2: the mean of V over page table[n, 0]
    survives the combine), one column, page edges, rows whose pages end
    exactly on a split boundary; one combine launch after the kernel."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    B, hq, hkv, ps, d, maxp = 32, 16, 8, 64, 128, 12
    splits = split_kv.split_count(B, hkv, maxp, split_kv.sm_count(dev))
    assert splits > 1
    rng, pk, pv, table = _layout(B, 2, hkv, ps, d, maxp, seed=105)
    lengths = _split_edges(B, ps, maxp, splits)
    q = torch.from_numpy(rng.standard_normal((B, hq, d)).astype(
        np.float32)).to(dev, dtype)
    lim = torch.from_numpy(lengths).to(dev)
    tab = torch.from_numpy(table).to(dev)
    if quant:
        pools = _int8_pools(rng, 2, B * maxp + 1, hkv, ps, d, dev)
    else:
        pools = [torch.from_numpy(a).to(dev, dtype) for a in (pk, pv)]
    before = split_kv.split_merge.launches
    if quant:
        out = tpa.paged_attention_quant(q, *pools, lim, 1, tab, window)
    else:
        out = tpa.paged_attention(q, *pools, lim, 1, tab, window)
    assert split_kv.split_merge.launches == before + 1
    ref = tpa.paged_attention_plain(q, pools[0], pools[1], lim, 1, tab,
                                    *pools[2:], window=window)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq", [16, 32])
@pytest.mark.parametrize("ps", [6, 10, 12, 100, 256])
def test_paged_attention_at_any_page_size(dev, quant, hq, ps):
    """K1 decode (several splits) and verify (5 rows a slot) at page sizes
    that are not a multiple of 4 (a stage's row of p is then not 16-byte
    aligned) or longer than one 64-row stage, with 2 and 4 query heads per
    kv head, bf16 q over a bf16 and an int8 pool, with a window of 3 pages
    less 1 row: within the bf16 tolerance of plain."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    B, hkv, d, maxp, R = 32, 8, 128, 6, 5
    rng, _, _, table = _layout(B, 2, 1, 1, 1, maxp, seed=110)
    P = B * maxp + 1
    if quant:
        pools = _int8_pools(rng, 2, P, hkv, ps, d, dev)
    else:
        gen = torch.Generator(dev).manual_seed(111)
        pools = [torch.randn((2, P, hkv, ps, d), generator=gen, device=dev,
                             dtype=torch.bfloat16) for _ in range(2)]
    lengths = np.resize(np.array([0, 1, ps - 1, ps, ps + 1, 3 * ps + 2,
                                  maxp * ps - R, maxp * ps - R - 1],
                                 np.int32), B)
    lim = torch.from_numpy(lengths).to(dev)
    tab = torch.from_numpy(table).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, R, hq, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    assert split_kv.split_count(B, hkv, maxp, split_kv.sm_count(dev)) > 1
    for window in (0, 3 * ps - 1):
        if quant:
            out = tpa.paged_attention_quant(q[:, 0].contiguous(), *pools,
                                            lim, 1, tab, window)
            spec = tpa.paged_attention_spec_quant(q, *pools, lim, 1, tab,
                                                  window)
        else:
            out = tpa.paged_attention(q[:, 0].contiguous(), *pools, lim, 1,
                                      tab, window)
            spec = tpa.paged_attention_spec(q, *pools, lim, 1, tab, window)
        ref = tpa.paged_attention_plain(q[:, 0].contiguous(), pools[0],
                                        pools[1], lim, 1, tab, *pools[2:],
                                        window=window)
        ref_spec = tpa.paged_attention_spec_plain(
            q, pools[0], pools[1], lim, 1, tab, *pools[2:], window=window)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
        assert (spec.float() - ref_spec.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 200])
def test_dense_attention_at_split_edges(dev, dtype, tol, quant, window):
    """K4 and K7 over 32 slots of 8 kv heads at the split edges (length
    0: zeros, C8), and K5 at 4 slots per CTA: the same launch as K4, so
    bit-identical to it (C11's zeros kept)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    B, S, hq, hkv, d = 32, 768, 16, 8, 128
    rng = np.random.default_rng(106)
    cache = _dense_cache(rng, B, S, hkv, d, dev,
                         torch.float32 if quant else dtype, quant)
    splits = tda.attention_splits(B, hkv, S, dev)
    assert splits > 1
    lengths = _split_edges(B, 64, S // 64, splits)
    lens = torch.from_numpy(lengths).to(dev)
    spec_lens = torch.from_numpy(np.minimum(lengths, S - 5)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, 5, hq, d)).astype(
        np.float32)).to(dev, dtype)
    before = split_kv.split_merge.launches
    k4 = _dense_call(tda, q[:, :1], cache, lens, 1, window, 1, 1)
    k5 = _dense_call(tda, q[:, :1], cache, lens, 1, window, 4, 1)
    k7 = _dense_call(tda, q, cache, spec_lens, 1, window, 1, 5)
    # the verify splits each (slot, row group, kv head)
    verify_splits = tda.attention_splits(
        B * split_kv.verify_groups(5, hq // hkv), hkv, S, dev)
    assert split_kv.split_merge.launches == before + 2 + (verify_splits > 1)
    ref4 = tda.dense_attention_plain(q[:, :1], cache[0], cache[1], lens, 1,
                                     window, *cache[2:])
    ref7 = tda.dense_attention_plain(q, cache[0], cache[1], spec_lens + 1, 1,
                                     window, *cache[2:])
    torch.cuda.synchronize()
    assert (k4.float() - ref4.float()).abs().max().item() <= tol
    assert (k7.float() - ref7.float()).abs().max().item() <= tol
    assert torch.equal(k4, k5)
    assert not k4[0].any()


@pytest.mark.parametrize("quant", [False, True])
def test_dense_attention_27000_rows(dev, quant):
    """K4 and K6 over 4 slots holding 41, 6,034, 14,002 and 27,033 rows of
    a 32768-row cache (the sp engine's prompts; one split per a few hundred
    tiles): K4 within the bf16 tolerance of plain, K6's triple within
    1e-4 relative of its plain version."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    B, S, hq, hkv, d = 4, 32768, 16, 8, 128
    rng = np.random.default_rng(107)
    if quant:
        cache = _int8_pools(rng, 2, B, hkv, S, d, dev)
    else:
        cache = [torch.randn((2, B, hkv, S, d), device=dev,
                             generator=torch.Generator(dev).manual_seed(
                                 108 + i), dtype=torch.bfloat16)
                 for i in range(2)]
    assert tda.attention_splits(B, hkv, S, dev) > 8
    lens = torch.tensor([41, 6034, 14002, 27033], dtype=torch.int32,
                        device=dev)
    q = torch.from_numpy(rng.standard_normal((B, 1, hq, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    out = _dense_call(tda, q, cache, lens, 1, 0, 1, 1)
    ref = tda.dense_attention_plain(q, cache[0], cache[1], lens, 1, 0,
                                    *cache[2:])
    acc, m, l_sum = tda.decode_attend_dense_stats(q, cache[0], cache[1],
                                                  lens, 1, *cache[2:])
    racc, rm, rl = tda.dense_attention_stats_plain(q, cache[0], cache[1],
                                                   lens, 1, *cache[2:])
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    torch.testing.assert_close(m, rm, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(l_sum, rl, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(acc / l_sum[..., None],
                               racc / rl[..., None], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_merge_matches_plain(dev, dtype):
    """The combine kernel against its plain version: empty splits (0,
    -1e30, 0) add nothing, a head whose only visited split is wholly masked
    (m -1e30, l > 0; a paged row at limit 0) keeps acc / l, and the raw
    triple (K6) within float32 rounding."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    rng = np.random.default_rng(109)
    splits, rows, hq, d = 5, 7, 4, 128
    acc = torch.from_numpy(rng.standard_normal((splits, rows, hq, d))
                           .astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.standard_normal((splits, rows, hq))
                         .astype(np.float32) * 3).to(dev)
    l_sum = torch.from_numpy(rng.uniform(1, 60, (splits, rows, hq))
                             .astype(np.float32)).to(dev)
    empty = torch.from_numpy(rng.uniform(size=(splits, rows, hq)) < 0.4) \
        .to(dev)
    empty[:, 0, 0] = True
    acc[empty], m[empty], l_sum[empty] = 0.0, -1e30, 0.0
    m[2, 0, 0], l_sum[2, 0, 0] = -1e30, 64.0
    acc[2, 0, 0] = torch.arange(d, dtype=torch.float32, device=dev)
    out = torch.empty((rows, hq, d), dtype=dtype, device=dev)
    split_kv.split_merge(acc, m, l_sum, out=out)
    raw = split_kv.split_merge(acc, m, l_sum)
    torch.cuda.synchronize()
    ref = split_kv.split_merge_plain(acc, m, l_sum, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.equal(out[0, 0].float(), (acc[2, 0, 0] / 64).to(dtype)
                       .float())
    for got, want in zip(raw, split_kv.split_merge_plain(acc, m, l_sum)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- the verify body (K1's verify entry, K7): one stream per slot -------------


def _verify_rows_ok(out, ref, n_rows):
    """bf16: each query row (its Hq x D outputs) within 4 bf16 ulps max and
    0.5 mean of the row's largest |plain output| (chip_smoke.py's rule);
    float32: 1e-5 (float32 sums in another order)."""
    diff = (out.float() - ref.float()).abs().reshape(n_rows, -1)
    if out.dtype == torch.float32:
        return diff.max().item() <= 1e-5
    top = ref.float().abs().reshape(n_rows, -1).amax(1).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return bool(((diff.amax(1) / ulp) <= 4).all()
                and ((diff.mean(1) / ulp) <= 0.5).all())


def _verify_case(dev, kind, dtype, quant, lengths, R, hq, hkv, d, tile,
                 tiles, window, seed):
    """The verify kernel (``kind`` "paged": K1's verify entry over pages of
    ``tile`` rows, ``tiles`` a slot; "dense": K7 over [2, B, hkv, 64 *
    tiles, d]) against its plain version at q [B, R, hq, d] of ``dtype``
    (the pool bf16/f32 of that type or int8); then again with NaN (int8:
    NaN scales) in every page or row outside each slot's range (below row
    0's window start, past column lengths + R - 1): the output must be
    bit-identical to the clean run's. Returns the number of combine
    launches of the clean run."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    B = len(lengths)
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, R, hq, d)).astype(
        np.float32)).to(dev, dtype)
    lens = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    lo_col = np.maximum(np.asarray(lengths) + 1 - window, 0) if window \
        else np.zeros(B, np.int64)
    end_col = np.asarray(lengths) + R
    if kind == "paged":
        P = B * tiles + 2
        nan_page = P - 1
        store = _int8_pools(rng, 2, P, hkv, tile, d, dev) if quant else [
            torch.from_numpy(rng.standard_normal((2, P, hkv, tile, d))
                             .astype(np.float32)).to(dev, dtype)
            for _ in range(2)]
        table = (rng.permutation(B * tiles) + 1).reshape(B, tiles) \
            .astype(np.int32)
        dirty_table = table.copy()
        for b in range(B):
            dirty_table[b, :lo_col[b] // tile] = nan_page
            dirty_table[b, -(-end_col[b] // tile):] = nan_page
        dirty = [t.clone() for t in store]
        for t in (dirty[2:] if quant else dirty):
            t[:, nan_page] = float("nan")
        fn = tpa.paged_attention_spec_quant if quant \
            else tpa.paged_attention_spec

        def run(kv, tab):
            return fn(q, *kv, lens, 1, torch.from_numpy(tab).to(dev),
                      window)

        def plain():
            return tpa.paged_attention_spec_plain(
                q, store[0], store[1], lens, 1,
                torch.from_numpy(table).to(dev), *store[2:], window=window)

        args = ((store, table), (dirty, dirty_table))
        n_tiles = tiles
    else:
        S = 64 * tiles
        store = _dense_cache(rng, B, S, hkv, d, dev, dtype, quant)
        dirty = [t.clone() for t in store]
        for b in range(B):
            for t in (dirty[2:] if quant else dirty):
                t[1, b, :, :lo_col[b] // 64 * 64] = float("nan")
                t[1, b, :, end_col[b]:] = float("nan")

        def run(kv, _):
            kw = {"cache_ks": kv[2], "cache_vs": kv[3]} if quant else {}
            return tda.spec_attend_dense(q, kv[0], kv[1], lens, 1, window,
                                         **kw)

        def plain():
            return tda.dense_attention_plain(q, store[0], store[1], lens + 1,
                                             1, window, *store[2:])

        args = ((store, None), (dirty, None))
        n_tiles = tiles
    before = split_kv.split_merge.launches
    out = run(*args[0])
    merges = split_kv.split_merge.launches - before
    bad = run(*args[1])
    ref = plain()
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert _verify_rows_ok(out, ref, B * R)
    assert torch.isfinite(bad.float()).all() and torch.equal(out, bad)
    splits = split_kv.split_count(B * split_kv.verify_groups(R, hq // hkv),
                                  hkv, n_tiles, split_kv.sm_count(dev))
    assert merges == (splits > 1)
    return splits


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window_tiles", [0, 3])
def test_verify_at_split_edges(dev, kind, dtype, quant, window_tiles):
    """8 slots of 5 rows over 8 kv heads, 24 tiles a slot (several splits
    on a card of 132 SMs, one combine launch): slot ranges that end one
    column before, on and one past a split boundary, a first row of length
    0, and windows of 3 tiles whose start moves across a tile edge between
    a slot's rows; NaN outside each slot's range read by none."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    R, hq, hkv, d, tiles = 5, 16, 8, 128, 24
    tile = 16 if kind == "paged" else 64
    splits = split_kv.split_count(8, hkv, tiles, split_kv.sm_count(dev))
    per = -(-tiles // splits)
    edges = [per * k * tile - R for k in range(1, 3)]
    window = window_tiles * tile
    # with a window, rows 2-4 of the last slot start in the tile after row
    # 0's: a split of that one tile holds only masked columns for them
    lengths = [0, tile - R, edges[0] - 1, edges[0], edges[0] + 1, edges[1],
               tiles * tile - R, window + tile - 3]
    got = _verify_case(dev, kind, dtype, quant, lengths, R, hq, hkv, d, tile,
                       tiles, window, seed=120)
    assert got == splits and splits > 1


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("R", [1, 2, 5, 9])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_verify_row_and_head_counts(dev, kind, quant, R, G):
    """R x G query rows a slot from 1 to 72 (one 16-row tile, two, four,
    and two row groups of 64), bf16 q over a bf16 and an int8 store, window
    0 and 3 tiles: within 4 bf16 ulps of plain per row."""
    hkv, d, tiles = 2, 64, 6
    tile = 16 if kind == "paged" else 64
    lengths = [0, 1, tile - 1, 2 * tile + 3, tiles * tile - R - 1,
               tiles * tile - R]
    for window in (0, 3 * tile):
        _verify_case(dev, kind, torch.bfloat16, quant, lengths, R, G * hkv,
                     hkv, d, tile, tiles, window, seed=121 + R * G)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq", [16, 32])
@pytest.mark.parametrize("ps", [6, 10, 12, 100, 256])
def test_verify_at_any_page_size(dev, quant, hq, ps):
    """K1's verify entry at page sizes below, across and above the body's
    64-column stage (a stage padded past the page's rows; a page of several
    stages), G 2 and 4, window 0 and 3 pages, NaN outside each slot's
    pages."""
    R, hkv, d, maxp = 5, 8, 128, 6
    lengths = [0, 1, ps - R, ps, 3 * ps + 2, maxp * ps - R,
               maxp * ps - R - 1, 2 * ps - 3]
    for window in (0, 3 * ps):
        _verify_case(dev, "paged", torch.bfloat16, quant, lengths, R, hq,
                     hkv, d, ps, maxp, window, seed=130 + ps)


def _launch_totals():
    from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    return {**tpa.launch_counts(), **dense_attention.launch_counts(),
            **split_kv.launch_counts()}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_decode_graph_replays_eager_decode_steps(dev, paged, quant):
    """``DecodeGraphs`` captured on the card: a replay of a 3-substep
    horizon (rows that sample among greedy ones) against eager
    ``decode_steps`` on a clone of the same paged pool or dense cache: the
    same tokens, bit-identical caches (every written K/V row and scale),
    the carry left in the operand buffers, and the kernels' launch counts
    of the replay equal to the eager run's."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        DecoderLM, init_params)
    from aws_k8s_ansible_provisioner_tpu_torch.ops import (dense_attention,
                                                           split_kv)
    from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv
    from aws_k8s_ansible_provisioner_tpu_torch.serving import programs

    cfg = tiny_qwen3()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    model = DecoderLM(cfg, init_params(cfg, gen, torch.bfloat16))
    B, ps, maxp, S = 4, 8, 6, 48
    rng = np.random.default_rng(5)
    if paged:
        cache = pkv.init_pool(cfg, B * maxp + 1, ps, torch.bfloat16, dev,
                              quant=quant)
        table = torch.from_numpy((rng.permutation(B * maxp) + 1).reshape(
            B, maxp).astype(np.int32)).to(dev)
    else:
        cache = kvc.init_cache(cfg, B, S, torch.bfloat16, dev, quant=quant)
        table = None
    for leaf in cache.values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device=dev, dtype=torch.int8))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen, device=dev)
                       * (0.02 if quant else 1.0))
    graphs = programs.DecodeGraphs(model, cache, B, maxp if paged else None,
                                   (1, 3), capture=True)
    assert sorted(graphs.graphs) == sorted(
        (h,) + v for h in (1, 3) for v in programs.DecodeGraphs.VARIANTS)
    assert graphs.capture_s > 0
    operands = (torch.tensor([3, 9, 27, 81], dtype=torch.int32),
                torch.tensor([0, 7, 20, 40], dtype=torch.int32),
                torch.tensor([0.0, 0.8, 0.0, 1.1]),
                torch.tensor([0, 20, 0, 5], dtype=torch.int32),
                torch.tensor([1.0, 0.9, 1.0, 0.8]),
                torch.tensor([1, 2**32 - 1, 3, 4], dtype=torch.int64))
    operands = tuple(t.to(dev) for t in operands)
    for dst, src in zip((graphs.tokens, graphs.lengths, graphs.temps,
                         graphs.top_ks, graphs.top_ps, graphs.seeds),
                        operands):
        dst.copy_(src)
    if paged:
        graphs.table.copy_(table)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    counters = (tpa, dense_attention, split_kv)
    torch.cuda.synchronize()
    for module in counters:
        module.reset_launch_counts()
    _, ref = programs.decode_steps(model, 3, eager_cache, operands[0],
                                   operands[1], table, *operands[2:],
                                   any_sampled=True)
    eager_counts = _launch_totals()
    for module in counters:
        module.reset_launch_counts()
    out = graphs.run(3, True).clone()
    torch.cuda.synchronize()
    assert _launch_totals() == eager_counts
    assert max(eager_counts.values()) > 0
    assert torch.equal(out, ref)
    assert torch.equal(graphs.tokens, ref[-1])
    assert torch.equal(graphs.lengths, operands[1] + 3)
    for k in cache:
        assert torch.equal(cache[k], eager_cache[k]), k
    with pytest.raises(RuntimeError):
        graphs.run(2, False)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_graph_variants_replay_eager_decode_steps(dev, paged):
    """Each logit variant of ``DecodeGraphs`` (penalties, logprobs, both;
    bias and ban rows always on, padded rows among them) replayed on the
    card against eager ``decode_steps`` of the same variant on clones of
    the cache and the count carry: tokens, logprob records, counts and
    every K/V row bit-identical."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        DecoderLM, init_params)
    from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv
    from aws_k8s_ansible_provisioner_tpu_torch.serving import programs

    cfg = tiny_qwen3()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    model = DecoderLM(cfg, init_params(cfg, gen, torch.bfloat16))
    B, ps, maxp, S, V = 4, 8, 6, 48, cfg.vocab_size
    rng = np.random.default_rng(6)
    if paged:
        cache = pkv.init_pool(cfg, B * maxp + 1, ps, torch.bfloat16, dev)
        table = torch.from_numpy((rng.permutation(B * maxp) + 1).reshape(
            B, maxp).astype(np.int32)).to(dev)
    else:
        cache = kvc.init_cache(cfg, B, S, torch.bfloat16, dev)
        table = None
    for leaf in cache.values():
        leaf.copy_(torch.rand(leaf.shape, generator=gen, device=dev))
    graphs = programs.DecodeGraphs(model, cache, B, maxp if paged else None,
                                   (2,), capture=True)
    ban = np.full((B, programs.BAN_K), programs.NO_TOKEN, np.int32)
    ban[0, :2], ban[2, :1] = [3, V + 4], [-1]
    bias = np.full((B, programs.BIAS_K), programs.NO_TOKEN, np.int32)
    bias[1, :3], bias[3, :1] = [5, 9, 2**31 - 2], [11]
    vals = np.zeros((B, programs.BIAS_K), np.float32)
    vals[1, :3], vals[3, :1] = [2.0, -100.0, 7.0], [100.0]
    ops = dict(
        tokens=[3, 9, 27, 81], lengths=[0, 7, 20, 40],
        temps=[0.0, 0.8, 0.0, 1.1], top_ks=[0, 20, 0, 5],
        top_ps=[1.0, 0.9, 1.0, 0.8], seeds=[1, 2**32 - 1, 3, 4],
        ban_ids=ban, ban_until=[30, 0, 25, 0], bias_ids=bias,
        bias_vals=vals, presence=[0.5, 0.0, 1.5, 0.0],
        frequency=[0.25, 0.0, 0.0, 0.7], repetition=[1.3, 1.0, 1.0, 0.8],
        counts=rng.integers(0, 3, (B, V)), prompt_mask=rng.random((B, V))
        < 0.1)
    for name, value in ops.items():
        buf = getattr(graphs, name)
        buf.copy_(torch.as_tensor(np.asarray(value)).to(buf.dtype))
    if paged:
        graphs.table.copy_(table)
    state = {k: getattr(graphs, k).clone() for k in ("tokens", "lengths",
                                                     "counts")}
    for penalties, logprobs in ((True, False), (False, True), (True, True)):
        for k, v in state.items():
            getattr(graphs, k).copy_(v)
        eager_cache = {k: v.clone() for k, v in cache.items()}
        counts = state["counts"].clone()
        pen = dict(counts=counts, presence=graphs.presence,
                   frequency=graphs.frequency,
                   repetition=graphs.repetition,
                   prompt_mask=graphs.prompt_mask) if penalties else {}
        _, ref = programs.decode_steps(
            model, 2, eager_cache, state["tokens"], state["lengths"], table,
            graphs.temps, graphs.top_ks, graphs.top_ps, graphs.seeds,
            any_sampled=True, ban_ids=graphs.ban_ids,
            ban_until=graphs.ban_until, bias_ids=graphs.bias_ids,
            bias_vals=graphs.bias_vals, logprobs=logprobs, **pen)
        out = graphs.run(2, True, penalties, logprobs)
        torch.cuda.synchronize()
        if logprobs:
            (out, lp), (ref, ref_lp) = out, ref
            for a, b in zip(lp, ref_lp):
                assert torch.equal(a, b)
        assert torch.equal(out, ref)
        assert torch.equal(graphs.counts, counts if penalties
                           else state["counts"])
        for k in cache:
            assert torch.equal(cache[k], eager_cache[k]), k


def _adapter_params(cfg, params, n, r, seed):
    """``params`` with ``n`` seeded in-memory adapters of rank ``r`` over all
    seven targets attached (``models/lora.py``)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models import lora

    rng = np.random.default_rng(seed)
    dims = {"wq": (cfg.hidden_size, cfg.q_size),
            "wk": (cfg.hidden_size, cfg.kv_size),
            "wv": (cfg.hidden_size, cfg.kv_size),
            "wo": (cfg.q_size, cfg.hidden_size),
            "w_gate": (cfg.hidden_size, cfg.intermediate_size),
            "w_up": (cfg.hidden_size, cfg.intermediate_size),
            "w_down": (cfg.intermediate_size, cfg.hidden_size)}
    L = cfg.num_layers
    loaded = [{"r": r, "targets": {
        t: ((0.3 * rng.standard_normal((L, din, r))).astype(np.float32),
            (0.3 * rng.standard_normal((L, r, dout))).astype(np.float32))
        for t, (din, dout) in dims.items()}} for _ in range(n)]
    return lora.attach(params, lora.stack_adapters(loaded, L),
                       torch.bfloat16)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("guided", [False, True], ids=["all-ones", "guided"])
@pytest.mark.parametrize("adapters", [False, True], ids=["base", "lora"])
def test_decode_graph_allow_and_lora_replay_eager_decode_steps(
        dev, paged, guided, adapters):
    """Every variant of ``DecodeGraphs`` (any row samples, penalties,
    logprobs) replayed with its always-on allow words (all ones, or a
    guided row's mask, bit 31 set in some of its words) and, over a model
    with two adapters attached, the adapter indices (base and both
    adapters among the rows): tokens, logprob records, counts and every
    K/V row bit-identical to eager ``decode_steps`` of the same variant and
    operands on clones."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        DecoderLM, init_params)
    from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as kvc
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv
    from aws_k8s_ansible_provisioner_tpu_torch.serving import programs

    cfg = tiny_qwen3()
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    params = init_params(cfg, gen, torch.bfloat16)
    if adapters:
        params = _adapter_params(cfg, params, 2, 4, 12)
    model = DecoderLM(cfg, params)
    assert model.has_lora == adapters
    B, ps, maxp, S, V = 4, 8, 6, 48, cfg.vocab_size
    rng = np.random.default_rng(13)
    if paged:
        cache = pkv.init_pool(cfg, B * maxp + 1, ps, torch.bfloat16, dev)
        table = torch.from_numpy((rng.permutation(B * maxp) + 1).reshape(
            B, maxp).astype(np.int32)).to(dev)
    else:
        cache = kvc.init_cache(cfg, B, S, torch.bfloat16, dev)
        table = None
    for leaf in cache.values():
        leaf.copy_(torch.rand(leaf.shape, generator=gen, device=dev))
    graphs = programs.DecodeGraphs(model, cache, B, maxp if paged else None,
                                   (2,), capture=True)
    assert (graphs.lora_idx is not None) == adapters
    words = np.full(graphs.allow.shape, 0xFFFFFFFF, np.uint32)
    if guided:
        words[2] = rng.integers(0, 2**32, words.shape[1], dtype=np.uint64)
        words[2, 0] |= np.uint32(1 << 31)
    graphs.allow.copy_(torch.from_numpy(words.view(np.int32)).to(dev))
    if adapters:
        graphs.lora_idx.copy_(torch.tensor([0, 1, 2, 1], dtype=torch.int32))
    ops = dict(
        tokens=[3, 9, 27, 81], lengths=[0, 7, 20, 40],
        temps=[0.0, 0.8, 0.0, 1.1], top_ks=[0, 20, 0, 5],
        top_ps=[1.0, 0.9, 1.0, 0.8], seeds=[1, 2**32 - 1, 3, 4],
        presence=[0.5, 0.0, 1.5, 0.0], frequency=[0.25, 0.0, 0.0, 0.7],
        repetition=[1.3, 1.0, 1.0, 0.8], counts=rng.integers(0, 3, (B, V)),
        prompt_mask=rng.random((B, V)) < 0.1)
    for name, value in ops.items():
        buf = getattr(graphs, name)
        buf.copy_(torch.as_tensor(np.asarray(value)).to(buf.dtype))
    if paged:
        graphs.table.copy_(table)
    state = {k: getattr(graphs, k).clone() for k in ("tokens", "lengths",
                                                     "counts")}
    for sampled, penalties, logprobs in programs.DecodeGraphs.VARIANTS:
        for k, v in state.items():
            getattr(graphs, k).copy_(v)
        eager_cache = {k: v.clone() for k, v in cache.items()}
        counts = state["counts"].clone()
        pen = dict(counts=counts, presence=graphs.presence,
                   frequency=graphs.frequency,
                   repetition=graphs.repetition,
                   prompt_mask=graphs.prompt_mask) if penalties else {}
        _, ref = programs.decode_steps(
            model, 2, eager_cache, state["tokens"], state["lengths"], table,
            graphs.temps, graphs.top_ks, graphs.top_ps, graphs.seeds,
            any_sampled=sampled, ban_ids=graphs.ban_ids,
            ban_until=graphs.ban_until, bias_ids=graphs.bias_ids,
            bias_vals=graphs.bias_vals, allow=graphs.allow,
            lora_idx=graphs.lora_idx, logprobs=logprobs, **pen)
        out = graphs.run(2, sampled, penalties, logprobs)
        torch.cuda.synchronize()
        if logprobs:
            (out, lp), (ref, ref_lp) = out, ref
            for a, b in zip(lp, ref_lp):
                assert torch.equal(a, b)
        assert torch.equal(out, ref), (sampled, penalties, logprobs)
        if guided:
            # the guided row drew only tokens its words allow
            for t in out[:, 2].tolist():
                assert (int(words[2, t >> 5]) >> (t & 31)) & 1
        assert torch.equal(graphs.counts, counts if penalties
                           else state["counts"])
        for k in cache:
            assert torch.equal(cache[k], eager_cache[k]), k


def _random_pool(dev, gen, cfg, pages, ps, quant):
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv

    pool = pkv.init_pool(cfg, pages, ps, torch.bfloat16, dev, quant=quant)
    for leaf in pool.values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device=dev, dtype=torch.int8))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen, device=dev)
                       * (0.02 if quant else 1.0))
    return pool


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_host_tier_spill_then_restore_bit_identical(dev, quant):
    """Pages spilled to the tier's pinned page slots (a gather and
    non_blocking copies, nothing waited for) and overwritten on the stream
    right after: the restore into other pages gives the spilled bytes back,
    scales included, in place; the host slots are pinned."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv

    cfg = tiny_qwen3()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    pool = _random_pool(dev, gen, cfg, 16, 8, quant)
    src, dst = [3, 7, 10], [1, 14, 5]
    want = {n: a[:, src].clone() for n, a in pool.items()}
    page_bytes = sum(a[:, 0].numel() * a.element_size()
                     for a in pool.values())
    shapes = {n: (a.shape[0],) + tuple(a.shape[2:]) for n, a in pool.items()}
    tier = pkv.HostTier(64 * page_bytes)
    tier.reserve(pool)
    log = [(p, pkv.PagePool.chain_key(None, (p,) * 8), (p,) * 8)
           for p in src]
    tier.spill(log, pkv.gather_pages(pool, src), page_bytes)
    for a in pool.values():                # queued after the spill
        a[:, src] = 0
    ptrs = {n: a.data_ptr() for n, a in pool.items()}
    entries = [tier.fetch(k, t, shapes) for _, k, t in log]
    assert all(e is not None for e in entries)
    assert all(x.is_pinned() for e in entries for x in e.values())
    pkv.restore_pages(pool, dst, pkv.upload_pages(entries, dev))
    torch.cuda.synchronize()
    for n, a in pool.items():
        assert a.data_ptr() == ptrs[n]
        assert torch.equal(a[:, dst], want[n]), n
    tier.flush_to_host()                   # the copies have finished
    assert not tier._copies


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_decode_graph_replay_after_restore_matches_eager(dev, quant):
    """Decode graphs captured over a pool, then host pages restored into
    pages the table reads: a replay sees the restored rows (the restore
    wrote the captured storage), with the tokens and every cache leaf of
    eager ``decode_steps`` on a clone of the restored pool."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import tiny_qwen3
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        DecoderLM, init_params)
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv
    from aws_k8s_ansible_provisioner_tpu_torch.serving import programs

    cfg = tiny_qwen3()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    model = DecoderLM(cfg, init_params(cfg, gen, torch.bfloat16))
    B, ps, maxp = 4, 8, 6
    pool = _random_pool(dev, gen, cfg, B * maxp + 1 + 4, ps, quant)
    rng = np.random.default_rng(6)
    table = torch.from_numpy((rng.permutation(B * maxp) + 1).reshape(
        B, maxp).astype(np.int32)).to(dev)
    graphs = programs.DecodeGraphs(model, pool, B, maxp, (1, 3),
                                   capture=True)
    # spill the spare pages past the table's, restore them over pages the
    # table's live rows read
    spare = list(range(B * maxp + 1, B * maxp + 5))
    page_bytes = sum(a[:, 0].numel() * a.element_size()
                     for a in pool.values())
    shapes = {n: (a.shape[0],) + tuple(a.shape[2:]) for n, a in pool.items()}
    tier = pkv.HostTier(64 * page_bytes)
    tier.reserve(pool)
    log = [(p, pkv.PagePool.chain_key(None, (p,) * ps), (p,) * ps)
           for p in spare]
    tier.spill(log, pkv.gather_pages(pool, spare), page_bytes)
    targets = [int(table[b, 0]) for b in range(B)]
    entries = [tier.fetch(k, t, shapes) for _, k, t in log]
    pkv.restore_pages(pool, targets, pkv.upload_pages(entries, dev))
    operands = (torch.tensor([3, 9, 27, 81], dtype=torch.int32),
                torch.tensor([5, 7, 20, 40], dtype=torch.int32),
                torch.tensor([0.0, 0.8, 0.0, 1.1]),
                torch.tensor([0, 20, 0, 5], dtype=torch.int32),
                torch.tensor([1.0, 0.9, 1.0, 0.8]),
                torch.tensor([1, 2**32 - 1, 3, 4], dtype=torch.int64))
    operands = tuple(t.to(dev) for t in operands)
    for dst, src in zip((graphs.tokens, graphs.lengths, graphs.temps,
                         graphs.top_ks, graphs.top_ps, graphs.seeds),
                        operands):
        dst.copy_(src)
    graphs.table.copy_(table)
    eager_pool = {k: v.clone() for k, v in pool.items()}
    for n in pool:
        assert torch.equal(eager_pool[n][:, targets],
                           eager_pool[n][:, spare])
    _, ref = programs.decode_steps(model, 3, eager_pool, operands[0],
                                   operands[1], table, *operands[2:],
                                   any_sampled=True)
    out = graphs.run(3, True).clone()
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    for k in pool:
        assert torch.equal(pool[k], eager_pool[k]), k


# -- K1's ragged entry: the chunk body (csrc/split_chunk.cuh) -----------------


def _rows_within_ulps(out, ref, n_rows, max_ulps=1.0, mean_ulps=0.5):
    """Each query row (its Hq x D outputs) within ``max_ulps`` bf16 ulps max
    and ``mean_ulps`` mean of the row's largest |plain output|."""
    diff = (out.float() - ref.float()).abs().reshape(n_rows, -1)
    top = ref.float().abs().reshape(n_rows, -1).amax(1).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return bool(((diff.amax(1) / ulp) <= max_ulps).all()
                and ((diff.mean(1) / ulp) <= mean_ulps).all())


def _chunk_case(dev, quant, G, ps, window, C, pstart, seed, hkv=2, d=128,
                maxp=None, B=5):
    """``ragged_attend_paged`` with ``chunk_start`` = B over B decode rows
    (slot 1 the dead passenger, limit 0) and C chunk rows of slot 1 at
    limits pstart + 1 .. pstart + C, bf16 q over a bf16 or an int8 pool,
    against ``paged_attention_plain`` row by row (1 bf16 ulp max, 0.5
    mean), as is the entry without the layout (the per-row body over every
    row, whose split count counts all B + C rows); then again with every table entry
    outside the rows' pages (below the chunk's first row's window start's
    page, past its last row's last page; for a decode row, outside its own
    pages) at a page of NaN (int8: NaN scales): the output must be
    bit-identical. Returns the chunk body's split count."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    rng = np.random.default_rng(seed)
    hq = G * hkv
    maxp = maxp or -(-(pstart + C) // ps) + 2
    P = B * maxp + 2
    nan_page = P - 1
    if quant:
        store = _int8_pools(rng, 2, P, hkv, ps, d, dev)
    else:
        store = [torch.from_numpy(rng.standard_normal(
            (2, P, hkv, ps, d)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2)]
    table = (rng.permutation(B * maxp) + 1).reshape(B, maxp).astype(np.int32)
    lengths = rng.integers(1, maxp * ps + 1, B).astype(np.int32)
    lengths[1] = 0
    limits = np.concatenate([lengths, pstart + 1 + np.arange(C)]) \
        .astype(np.int32)
    tables = np.concatenate([table, np.repeat(table[1][None], C, 0)])
    lo, hi = _lo_hi(limits, ps, maxp, window)
    dirty = tables.copy()
    for n in range(B + C):
        first, last = (lo[B], hi[-1]) if n >= B else (lo[n], hi[n])
        dirty[n, :first] = nan_page
        dirty[n, last + 1:] = nan_page
    bad = [t.clone() for t in store]
    for t in (bad[2:] if quant else bad):
        t[:, nan_page] = float("nan")
    q = torch.from_numpy(rng.standard_normal((B + C, hq, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    lim = torch.from_numpy(limits).to(dev)
    fn = tpa.paged_attention_quant if quant else tpa.paged_attention

    def run(kv, tab, chunk_start=B):
        return tpa.ragged_attend_paged(
            q, kv[0], kv[1], lim, 1, torch.from_numpy(tab).to(dev),
            *kv[2:], window=window, chunk_start=chunk_start)

    before = tpa.launch_counts()
    out = run(store, tables)
    after = tpa.launch_counts()
    assert after[fn.__name__ + " chunk"] == before[fn.__name__ + " chunk"] + 1
    assert after[fn.__name__ + " chunk window"] == \
        before[fn.__name__ + " chunk window"] + (window > 0)
    per_row = run(store, tables, None)
    poisoned = run(bad, dirty)
    ref = tpa.paged_attention_plain(q, store[0], store[1], lim, 1,
                                    torch.from_numpy(tables).to(dev),
                                    *store[2:], window=window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rows_within_ulps(out, ref, B + C)
    assert _rows_within_ulps(per_row, ref, B + C)
    assert torch.isfinite(poisoned.float()).all()
    assert torch.equal(out, poisoned)
    return split_kv.chunk_splits(C, G, hkv, maxp, split_kv.sm_count(dev),
                                 d)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_ragged_chunk_body_matches_plain(dev, quant, window, G):
    """Chunks of 1 row, of fewer rows than a row tile, of a row tile and one
    more, and of several tiles that do not fill the last, starting inside a
    page, over 2 kv heads at page 64 (D 128), with and without a window."""
    for C, pstart in ((1, 0), (1, 300), (37, 5), (128 // G + 1, 70),
                      (300, 130)):
        _chunk_case(dev, quant, G, 64, window, C, pstart, seed=140 + C + G)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ps", [16, 32, 64, 128])
def test_ragged_chunk_body_at_page_sizes(dev, quant, ps):
    """Page sizes below, at and above the body's 64-column stage (a page of
    16 rows fills a quarter of a stage, one of 128 two stages), G 2 and 4,
    window 0 and 3 pages less 5 rows, a chunk that starts and ends inside
    a page and a padded tail past the allocated pages (limits beyond the
    table's pages clamp to its last page)."""
    for G in (2, 4):
        for window in (0, 3 * ps - 5):
            _chunk_case(dev, quant, G, ps, window, 150, 2 * ps + 3,
                        seed=150 + ps + G)
            # the table's pages end inside the chunk: its last rows' limits
            # run past them
            _chunk_case(dev, quant, G, ps, window, 100, ps + 20,
                        seed=160 + ps + G, maxp=(ps + 70) // ps)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 640])
def test_ragged_chunk_body_at_split_edges(dev, quant, window):
    """A chunk of one row tile (64 rows at G 2) over 8 kv heads, whose
    split count (33 on 132 SMs) then takes up to 33 pages a split: page
    ranges of one page (empty splits after it), of one page fewer than the
    splits, as many, one more (a split of two pages) and twice as many
    plus one, and one that fills the table."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

    hkv, ps, maxp, C = 8, 64, 80, 64
    splits = split_kv.chunk_splits(C, 2, hkv, maxp, split_kv.sm_count(dev))
    assert 1 < splits and 2 * splits + 1 < maxp
    for pages in (1, splits - 1, splits, splits + 1, 2 * splits + 1,
                  maxp - 2):
        pstart = max(pages * ps - C - 3, 0)
        got = _chunk_case(dev, quant, 2, ps, window, C, pstart,
                          seed=170 + pages, hkv=hkv, maxp=maxp)
        assert got == splits


# -- the fused q/k prologue and row write (K2, K3 with the prologue) --------


def _bf16_ulp_of_rows(ref):
    """bf16 ulp of each head row's largest |value| (8 significant bits),
    broadcast over the row."""
    top = ref.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(top)) - 7)


def _prep_inputs(dev, dtype, quant, norm, hq, hkv, d, seed, rot=None):
    """Dropped rows (-1, past the window, OOB_PAGE tables), kept rows and
    chunk rows sharing one table's pages; raw q/k/v rows of ``dtype``, the
    RoPE tables of the rows' positions over ``rot`` columns (default d),
    norm weights (or none), a random pool (int8 with scales when
    ``quant``)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        QKPrep, rope_cos_sin)

    maxp, ps, N = 3, 8, 8
    rng, _, _, table = _layout(N, 1, hkv, ps, 16, maxp, seed=seed)
    table[0, :] = OOB_PAGE
    table[1, :] = OOB_PAGE
    table[5:] = table[4]
    rows = np.array([-1, maxp * ps, 0, 23, 12, 13, 14, 15], np.int32)
    positions = np.maximum(rows, 0) + rng.integers(0, 30000)
    t = [torch.from_numpy((3 * rng.standard_normal(shape)).astype(
        np.float32)).to(dev, dtype)
        for shape in ((N, hq, d), (N, hkv, d), (N, hkv, d))]
    weights = (None, None)
    if norm:
        weights = tuple(torch.from_numpy(
            (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(
                dev, dtype) for _ in range(2))
    cos, sin = rope_cos_sin(torch.from_numpy(positions).to(dev),
                            d if rot is None else rot, 1e6)
    prep = QKPrep(*weights, 1e-6, cos.contiguous(), sin.contiguous())
    P = N * maxp + 1
    if quant:
        pools = _int8_pools(rng, 2, P, hkv, ps, d, dev)
    else:
        pools = [torch.from_numpy(rng.standard_normal((2, P, hkv, ps, d))
                                  .astype(np.float32)).to(dev, dtype)
                 for _ in range(2)]
    return (t, torch.from_numpy(rows).to(dev),
            torch.from_numpy(table).to(dev), prep, pools)


def _close_rows(got, ref, dtype):
    """bf16: every element within one bf16 ulp of its head row's largest
    |plain value| (the norm's sum of squares is taken in another order);
    float32: within 1e-5 of that value."""
    diff = (got.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        return bool((diff <= _bf16_ulp_of_rows(ref)).all())
    top = ref.float().abs().amax(-1, keepdim=True)
    return bool((diff <= 1e-5 * top.clamp_min(1.0)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("norm", [True, False], ids=["qk_norm", "rope"])
@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 128), (32, 8, 128),
                                      (4, 2, 64), (8, 2, 256), (4, 2, 16)])
def test_prep_write_matches_plain(dev, dtype, norm, hq, hkv, d):
    """The fused write over a bf16/f32 pool: q and the written k rows
    within the row tolerance of the plain version (bit-identical without
    the norm), v and every untouched row bit-identical, one launch."""
    (q, k, v), rows, table, prep, pools = _prep_inputs(
        dev, dtype, False, norm, hq, hkv, d, seed=40)
    ref = [p.clone() for p in pools]
    before = tpa.prep_write_rows_paged.launches
    got_q = tpa.prep_write_rows_paged(*pools, q, k, v, rows, 1, table, prep)
    assert tpa.prep_write_rows_paged.launches == before + 1
    ref_q = tpa.prep_write_rows_paged_plain(*ref, q, k, v, rows, 1, table,
                                            prep)
    torch.cuda.synchronize()
    assert got_q.dtype == dtype and got_q.shape == q.shape
    assert torch.equal(pools[1], ref[1])
    if norm:
        assert _close_rows(got_q, ref_q, dtype)
        assert _close_rows(pools[0], ref[0], dtype)
    else:
        assert torch.equal(got_q, ref_q) and torch.equal(pools[0], ref[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("norm", [True, False], ids=["qk_norm", "rope"])
@pytest.mark.parametrize("hq,hkv,d", [(16, 8, 128), (32, 8, 128),
                                      (4, 2, 64), (8, 2, 256), (4, 2, 16)])
def test_prep_write_quant_matches_plain(dev, dtype, norm, hq, hkv, d):
    """The fused write's int8 instance: v's codes and scales bit-identical;
    k's codes within 1 and scales within 2^-8 relative of the plain
    version's, and bit-identical on every (row, head) whose k row after
    the prologue (the bf16/f32 instance's) is bit-identical to plain."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import \
        prep_qk_plain

    (q, k, v), rows, table, prep, pools = _prep_inputs(
        dev, dtype, True, norm, hq, hkv, d, seed=41)
    ref = [p.clone() for p in pools]
    before = tpa.prep_write_rows_quant_paged.launches
    got_q = tpa.prep_write_rows_quant_paged(*pools, q, k, v, rows, 1, table,
                                            prep)
    assert tpa.prep_write_rows_quant_paged.launches == before + 1
    ref_q = tpa.prep_write_rows_quant_paged_plain(*ref, q, k, v, rows, 1,
                                                  table, prep)
    # the kernel's k rows after the prologue, from its bf16/f32 instance
    rows_pool = [torch.zeros(pools[0].shape, dtype=dtype, device=dev)
                 for _ in range(2)]
    tpa.prep_write_rows_paged(*rows_pool, q, k, v, rows, 1, table, prep)
    _, k_plain = prep_qk_plain(q, k, prep)
    torch.cuda.synchronize()
    assert torch.equal(pools[1], ref[1]) and torch.equal(pools[3], ref[3])
    assert (pools[0].int() - ref[0].int()).abs().max() <= 1
    rel = ((pools[2] - ref[2]).abs() / ref[2]).max()
    assert rel <= 2.0 ** -8
    if not norm:
        assert torch.equal(got_q, ref_q)
    assert _close_rows(got_q, ref_q, dtype)
    # rows whose k after the prologue is bit-identical: identical codes
    ps = pools[0].shape[3]
    for n, row in enumerate(rows.tolist()):
        if not 0 <= row < table.shape[1] * ps:
            continue
        page, off = int(table[n, row // ps]), row % ps
        for h in range(hkv):
            if torch.equal(rows_pool[0][1, page, h, off], k_plain[n, h]):
                assert torch.equal(pools[0][1, page, h, off],
                                   ref[0][1, page, h, off])
                assert torch.equal(pools[2][1, page, h, off],
                                   ref[2][1, page, h, off])


def test_prep_write_refuses_what_the_kernel_does_not_take(dev):
    (q, k, v), rows, table, prep, pools = _prep_inputs(
        dev, torch.bfloat16, False, True, 4, 2, 64, seed=42)
    with pytest.raises(ValueError):           # D 40: not a multiple of 16
        tpa.prep_write_rows_paged(
            *(p[..., :40].contiguous() for p in pools), q[..., :40]
            .contiguous(), k[..., :40].contiguous(),
            v[..., :40].contiguous(), rows, 1, table,
            dataclasses.replace(prep, cos=prep.cos[:, :40].contiguous(),
                                sin=prep.sin[:, :40].contiguous()))
    with pytest.raises(ValueError):           # an odd rotary width
        tpa.prep_write_rows_paged(
            *pools, q, k, v, rows, 1, table,
            dataclasses.replace(prep, cos=prep.cos[:, :31].contiguous(),
                                sin=prep.sin[:, :31].contiguous()))
    with pytest.raises(TypeError):            # float32 weights, bf16 rows
        tpa.prep_write_rows_paged(
            *pools, q, k, v, rows, 1, table,
            dataclasses.replace(prep, q_norm=prep.q_norm.float(),
                                k_norm=prep.k_norm.float()))
    with pytest.raises(ValueError):           # tables of the wrong length
        tpa.prep_write_rows_paged(
            *pools, q, k, v, rows, 1, table,
            dataclasses.replace(prep, cos=prep.cos[:4], sin=prep.sin[:4]))


# -- the fused q/k prologue and dense row write (K8, K9 with the prologue) --


def _prep_dense_inputs(dev, dtype, quant, norm, hq, hkv, d, R, seed,
                       rot=None):
    """4 slots of R rows over a dense cache of 40 rows: kept rows at the
    cache's edges and dropped ones (-1, S, far past S); raw q/k/v rows
    [4, R, H, d] of ``dtype``, the RoPE tables [4, R, rot] (default d) of
    the rows' positions, norm weights (or none), a random cache [2, 4,
    hkv, 40, d] (int8 with scales when ``quant``)."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        QKPrep, rope_cos_sin)

    B, S = 4, 40
    rng = np.random.default_rng(seed)
    rows = np.array([0, 17, S - 2, S - 1])[:, None] + np.arange(R)
    rows[1, 0] = -1
    rows[2, -1] = 10 ** 6
    positions = np.maximum(rows, 0) + rng.integers(0, 30000)
    t = [torch.from_numpy((3 * rng.standard_normal(shape)).astype(
        np.float32)).to(dev, dtype)
        for shape in ((B, R, hq, d), (B, R, hkv, d), (B, R, hkv, d))]
    weights = (None, None)
    if norm:
        weights = tuple(torch.from_numpy(
            (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(
                dev, dtype) for _ in range(2))
    cos, sin = rope_cos_sin(torch.from_numpy(positions).to(dev),
                            d if rot is None else rot, 1e6)
    prep = QKPrep(*weights, 1e-6, cos.contiguous(), sin.contiguous())
    if quant:
        cache = _int8_pools(rng, 2, B, hkv, S, d, dev)
    else:
        cache = [torch.from_numpy(rng.standard_normal((2, B, hkv, S, d))
                                  .astype(np.float32)).to(dev, dtype)
                 for _ in range(2)]
    return t, torch.from_numpy(rows.astype(np.int32)).to(dev), prep, cache


PREP_DENSE = pytest.mark.parametrize("hq,hkv,d,R", [
    (16, 8, 128, 1), (16, 8, 128, 5), (32, 8, 128, 1), (4, 2, 64, 5),
    (4, 2, 16, 1), (4, 2, 16, 5)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("norm", [True, False], ids=["qk_norm", "rope"])
@PREP_DENSE
def test_prep_write_dense_matches_plain(dev, dtype, norm, hq, hkv, d, R):
    """The fused dense write over a bf16/f32 cache: q and the written k
    rows within the row tolerance of the plain version (bit-identical
    without the norm), v and every untouched row bit-identical, one
    launch."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    (q, k, v), rows, prep, cache = _prep_dense_inputs(
        dev, dtype, False, norm, hq, hkv, d, R, seed=60 + R)
    ref = [c.clone() for c in cache]
    before = tda.prep_write_rows_dense.launches
    got_q = tda.prep_write_rows_dense(*cache, q, k, v, rows, 1, prep)
    assert tda.prep_write_rows_dense.launches == before + 1
    ref_q = tda.prep_write_rows_dense_plain(*ref, q, k, v, rows, 1, prep)
    torch.cuda.synchronize()
    assert got_q.dtype == dtype and got_q.shape == q.shape
    assert torch.equal(cache[1], ref[1])
    if norm:
        assert _close_rows(got_q, ref_q, dtype)
        assert _close_rows(cache[0], ref[0], dtype)
    else:
        assert torch.equal(got_q, ref_q) and torch.equal(cache[0], ref[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("norm", [True, False], ids=["qk_norm", "rope"])
@PREP_DENSE
def test_prep_write_quant_dense_matches_plain(dev, dtype, norm, hq, hkv, d,
                                              R):
    """The fused dense write's int8 instance: v's codes and scales
    bit-identical; k's codes within 1 and scales within 2^-8 relative of
    the plain version's, and bit-identical on every (row, head) whose k row
    after the prologue (the bf16/f32 instance's) is bit-identical to
    plain."""
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import \
        prep_qk_plain
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    (q, k, v), rows, prep, cache = _prep_dense_inputs(
        dev, dtype, True, norm, hq, hkv, d, R, seed=70 + R)
    ref = [c.clone() for c in cache]
    before = tda.prep_write_rows_quant_dense.launches
    got_q = tda.prep_write_rows_quant_dense(*cache, q, k, v, rows, 1, prep)
    assert tda.prep_write_rows_quant_dense.launches == before + 1
    ref_q = tda.prep_write_rows_quant_dense_plain(*ref, q, k, v, rows, 1,
                                                  prep)
    # the kernel's k rows after the prologue, from its bf16/f32 instance
    rows_cache = [torch.zeros(cache[0].shape, dtype=dtype, device=dev)
                  for _ in range(2)]
    tda.prep_write_rows_dense(*rows_cache, q, k, v, rows, 1, prep)
    _, k_plain = prep_qk_plain(q, k, prep)
    torch.cuda.synchronize()
    assert torch.equal(cache[1], ref[1]) and torch.equal(cache[3], ref[3])
    assert (cache[0].int() - ref[0].int()).abs().max() <= 1
    rel = ((cache[2] - ref[2]).abs() / ref[2]).max()
    assert rel <= 2.0 ** -8
    if not norm:
        assert torch.equal(got_q, ref_q)
    assert _close_rows(got_q, ref_q, dtype)
    S = cache[0].shape[3]
    for b, slot_rows in enumerate(rows.tolist()):
        for r, row in enumerate(slot_rows):
            if not 0 <= row < S:
                continue
            for h in range(hkv):
                if torch.equal(rows_cache[0][1, b, h, row], k_plain[b, r, h]):
                    assert torch.equal(cache[0][1, b, h, row],
                                       ref[0][1, b, h, row])
                    assert torch.equal(cache[2][1, b, h, row],
                                       ref[2][1, b, h, row])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_prep_write_dense_sp_shard_rows(dev, quant):
    """An sp shard's rows (lengths - off; a non-owner's drop) through the
    fused dense write: the cache and scales of the bf16 instance (the rope
    only, bit for bit) or int8 instance equal the plain version's, and q
    goes out for the dropped rows too."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    (q, k, v), _, prep, cache = _prep_dense_inputs(
        dev, torch.bfloat16, quant, False, 16, 8, 128, 1, seed=80)
    S = cache[0].shape[3]
    lengths = torch.tensor([3, S - 1, S, 2 * S - 1], dtype=torch.int32,
                           device=dev)
    for off in (0, S):
        shard = [c.clone() for c in cache]
        ref = [c.clone() for c in cache]
        rows = (lengths - off)[:, None].contiguous()
        fn = tda.prep_write_rows_quant_dense if quant \
            else tda.prep_write_rows_dense
        got_q = fn(*shard, q, k, v, rows, 1, prep)
        plain = tda.prep_write_rows_quant_dense_plain if quant \
            else tda.prep_write_rows_dense_plain
        ref_q = plain(*ref, q, k, v, rows, 1, prep)
        torch.cuda.synchronize()
        assert torch.equal(got_q, ref_q)
        for got, want in zip(shard, ref):
            assert torch.equal(got, want)
        changed = (shard[1] != cache[1]).any(-1).any(2)[1]       # [B, S]
        assert int(changed.sum()) == 2


def test_prep_write_dense_refuses_what_the_kernel_does_not_take(dev):
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    (q, k, v), rows, prep, cache = _prep_dense_inputs(
        dev, torch.bfloat16, False, True, 4, 2, 64, 5, seed=42)
    with pytest.raises(ValueError):           # D 40: not a multiple of 16
        tda.prep_write_rows_dense(
            *(c[..., :40].contiguous() for c in cache),
            q[..., :40].contiguous(), k[..., :40].contiguous(),
            v[..., :40].contiguous(), rows, 1,
            dataclasses.replace(prep, q_norm=None, k_norm=None,
                                cos=prep.cos[..., :40].contiguous(),
                                sin=prep.sin[..., :40].contiguous()))
    with pytest.raises(TypeError):            # float32 weights, bf16 rows
        tda.prep_write_rows_dense(
            *cache, q, k, v, rows, 1,
            dataclasses.replace(prep, q_norm=prep.q_norm.float(),
                                k_norm=prep.k_norm.float()))
    with pytest.raises(ValueError):           # tables of the wrong rows
        tda.prep_write_rows_dense(
            *cache, q, k, v, rows, 1,
            dataclasses.replace(prep, cos=prep.cos[:, :2],
                                sin=prep.sin[:, :2]))
    with pytest.raises(ValueError):           # rows of other slots
        tda.prep_write_rows_dense(*cache, q, k, v, rows[:2], 1, prep)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_prep_write_empty_call_counts_no_launch(dev, quant):
    """A fused write of no rows (paged N = 0; dense R = 0) launches nothing,
    so its counter stays where it was, q comes back empty and the caches
    are untouched."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    (q, k, v), rows, table, prep, pools = _prep_inputs(
        dev, torch.bfloat16, quant, True, 4, 2, 16, seed=90)
    fn = tpa.prep_write_rows_quant_paged if quant \
        else tpa.prep_write_rows_paged
    ref = [p.clone() for p in pools]
    before = fn.launches
    out = fn(*pools, q[:0], k[:0], v[:0], rows[:0], 1, table[:0],
             dataclasses.replace(prep, cos=prep.cos[:0], sin=prep.sin[:0]))
    assert fn.launches == before and out.shape == (0,) + q.shape[1:]
    (q, k, v), rows, prep, cache = _prep_dense_inputs(
        dev, torch.bfloat16, quant, True, 4, 2, 16, 5, seed=91)
    fn = tda.prep_write_rows_quant_dense if quant \
        else tda.prep_write_rows_dense
    ref += [c.clone() for c in cache]
    before = fn.launches
    none = (slice(None), slice(0, 0))
    out = fn(*cache, q[none], k[none], v[none], rows[none], 1,
             dataclasses.replace(prep, cos=prep.cos[none],
                                 sin=prep.sin[none]))
    assert fn.launches == before and out.shape == q[none].shape
    torch.cuda.synchronize()
    for got, want in zip(pools + cache, ref):
        assert torch.equal(got, want)


def test_prefill_batch_of_three_within_logits_tolerance(dev):
    """C22, a difference by design: one prompt prefilled alone and in a
    batch of three (three copies of it, as an ``n`` = 3 request admits
    them) at the full width of Qwen3-0.6B (the engine's int8 weights, a
    bf16 paged pool, the same bucket and page in both runs). cuBLAS picks
    a GEMM's algorithm by its row count (on the H100 the MLP's down
    projection, 3072 -> 1024, sums 96 rows apart from 32, where the
    attention, the other projections and the logits head give the prompt's
    rows bit for bit; ``chip_smoke.phase_prefill_batch``), so the
    two prefills round apart: the first token's logits differ by at most
    the Qwen3 logits tolerance (0.1), and the greedy first token is the
    same."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import QWEN3_0_6B
    from aws_k8s_ansible_provisioner_tpu_torch.models.layers import (
        DecoderLM, init_params)
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quantize_params
    from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import \
        make_prefill_attend_batch_paged_carry
    from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as pkv

    cfg = QWEN3_0_6B
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = DecoderLM(cfg, quantize_params(init_params(cfg, gen,
                                                       torch.bfloat16), cfg))
    n, T = 16, 32
    prompt = torch.from_numpy(np.random.default_rng(22).integers(
        0, cfg.vocab_size, n).astype(np.int32)).to(dev)

    def first_logits(N):
        tokens = torch.zeros((N, T), dtype=torch.int32, device=dev)
        tokens[:, :n] = prompt
        lens = torch.full((N,), n, dtype=torch.int32, device=dev)
        tables = torch.arange(1, N + 1, dtype=torch.int32, device=dev)[:, None]
        pool = pkv.init_pool(cfg, N + 1, 64, torch.bfloat16, dev)
        positions = torch.arange(T, dtype=torch.int32,
                                 device=dev)[None].expand(N, T)
        logits, _ = model.forward_carry(
            tokens, positions, pool,
            make_prefill_attend_batch_paged_carry(tables, lens))
        return logits[:, n - 1].float()

    one, three = first_logits(1), first_logits(3)
    torch.cuda.synchronize()
    assert (one[0] - three[0]).abs().max().item() <= 0.1
    assert int(one[0].argmax()) == int(three[0].argmax())
    # the three copies in one batch agree with each other exactly
    assert torch.equal(three[0], three[1]) and torch.equal(three[0],
                                                           three[2])


# -- the other families' head dims: D 64, 80 and 256, partial and no RoPE --

# (Hq, Hkv, D, rotary width): Phi-2, OPT, Gemma-2B, Llama-3.2-1B; and two
# widths whose half is not a multiple of a lane's E elements (the
# prologue's two-shuffle path)
FAMILY_PREP = pytest.mark.parametrize("hq,hkv,d,rot", [
    (32, 32, 80, 32), (32, 32, 64, 0), (8, 1, 256, 256), (32, 8, 64, 64),
    (8, 2, 80, 20), (8, 2, 256, 36)],
    ids=["phi_d80_r32", "opt_d64_r0", "gemma_d256", "llama_d64", "d80_r20",
         "d256_r36"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("norm", [False, True], ids=["rope", "qk_norm"])
@FAMILY_PREP
def test_prep_write_family_shapes_match_plain(dev, dtype, quant, norm, hq,
                                              hkv, d, rot):
    """The fused paged and dense writes at the families' head dims (80 on
    20 of 32 lanes, 64, 256) and rotary widths (32 of 80: the partners 16
    columns apart, not D / 2; 0: no RoPE; 20 of 80 and 36 of 256, whose
    partners sit at another element of another lane): without the norm
    (these families have none) q and every cache leaf bit-identical to the
    plain version; with it (masked lanes in the sum of squares) q within
    the row tolerance. One launch each."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    (q, k, v), rows, table, prep, pools = _prep_inputs(
        dev, dtype, quant, norm, hq, hkv, d, seed=200 + d + rot, rot=rot)
    fn = tpa.prep_write_rows_quant_paged if quant \
        else tpa.prep_write_rows_paged
    plain = tpa.prep_write_rows_quant_paged_plain if quant \
        else tpa.prep_write_rows_paged_plain
    ref = [p.clone() for p in pools]
    before = fn.launches
    got_q = fn(*pools, q, k, v, rows, 1, table, prep)
    assert fn.launches == before + 1
    ref_q = plain(*ref, q, k, v, rows, 1, table, prep)
    (dq, dk, dv), drows, dprep, cache = _prep_dense_inputs(
        dev, dtype, quant, norm, hq, hkv, d, 5, seed=300 + d + rot, rot=rot)
    dfn = tda.prep_write_rows_quant_dense if quant \
        else tda.prep_write_rows_dense
    dplain = tda.prep_write_rows_quant_dense_plain if quant \
        else tda.prep_write_rows_dense_plain
    dref = [c.clone() for c in cache]
    before = dfn.launches
    got_dq = dfn(*cache, dq, dk, dv, drows, 1, dprep)
    assert dfn.launches == before + 1
    ref_dq = dplain(*dref, dq, dk, dv, drows, 1, dprep)
    torch.cuda.synchronize()
    if norm:
        assert _close_rows(got_q, ref_q, dtype)
        assert _close_rows(got_dq, ref_dq, dtype)
        assert torch.equal(pools[1], ref[1])
        assert torch.equal(cache[1], dref[1])
    else:
        assert torch.equal(got_q, ref_q) and torch.equal(got_dq, ref_dq)
        # k and v, and with int8 their scales, bit for bit
        assert all(torch.equal(a, b) for a, b in zip(pools, ref))
        assert all(torch.equal(a, b) for a, b in zip(cache, dref))
    if rot < d and not norm:
        # the columns past the rotary width pass through unrotated
        assert torch.equal(got_q[..., rot:], q[..., rot:])


# (Hq, Hkv, D): G 1 (Phi-2, OPT), 4 (Llama-3.2-1B), 8 (Gemma-2B, TinyLlama)
FAMILY_ATTN = pytest.mark.parametrize("hq,hkv,d", [
    (32, 32, 80), (32, 32, 64), (32, 8, 64), (8, 1, 256), (32, 4, 64)],
    ids=["phi", "opt", "llama", "gemma", "tinyllama"])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@FAMILY_ATTN
def test_family_paged_attention_matches_plain(dev, dtype, tol, quant, hq,
                                              hkv, d):
    """K1 (decode) and K1-spec (R = 5) at the families' head dims and head
    groups over pages of 64: rows of limit 0, one row, page edges, the
    full window, a split run; OOB_PAGE table entries past each row's
    live range."""
    maxp, ps, R = 6, 64, 5
    rng, _, _, table = _layout(6, 1, hkv, ps, 16, maxp, seed=210 + d + hq)
    P = 6 * maxp + 1
    if quant:
        pools = _int8_pools(rng, 2, P, hkv, ps, d, dev)
    else:
        pools = [torch.from_numpy(rng.standard_normal(
            (2, P, hkv, ps, d)).astype(np.float32)).to(dev, dtype)
            for _ in range(2)]
    lengths = np.array([0, 1, ps, ps + 1, maxp * ps - R, 3 * ps + 7],
                       np.int32)
    for n, lim in enumerate(lengths):
        table[n, max(-(-(int(lim) + R) // ps), 1):] = OOB_PAGE
    tab = torch.from_numpy(table).to(dev)
    lim = torch.from_numpy(lengths).to(dev)
    q = torch.from_numpy(rng.standard_normal((6, hq, d)).astype(
        np.float32)).to(dev, dtype)
    out = tpa.decode_attend_paged(q[:, None], pools[0], pools[1], lim, 1,
                                  tab, *pools[2:])
    ref = tpa.paged_attention_plain(q, pools[0], pools[1], lim, 1, tab,
                                    *pools[2:])
    qs = torch.from_numpy(rng.standard_normal((6, R, hq, d)).astype(
        np.float32)).to(dev, dtype)
    fn = tpa.paged_attention_spec_quant if quant else tpa.paged_attention_spec
    before = fn.launches
    sout = tpa.decode_attend_spec_paged(qs, pools[0], pools[1], lim, 1, tab,
                                        *pools[2:])
    assert fn.launches == before + 1
    sref = tpa.paged_attention_spec_plain(qs, pools[0], pools[1], lim, 1,
                                          tab, *pools[2:])
    torch.cuda.synchronize()
    assert (out[:, 0].float() - ref.float()).abs().max().item() <= tol
    assert (sout.float() - sref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@FAMILY_ATTN
def test_family_dense_attention_matches_plain(dev, dtype, tol, quant, hq,
                                              hkv, d):
    """K4 (one slot a CTA), K5 (4 a CTA) and K7 (R = 5) at the families'
    head dims and head groups: lengths 0, 1, a tile edge, the full window
    of 200 rows, a partial last tile."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import \
        dense_attention as tda

    B, S, R = 8, 200, 5
    rng = np.random.default_rng(220 + d + hq)
    cache = _dense_cache(rng, B, S, hkv, d, dev, dtype, quant)
    for lengths, rows, bb in (([0, 1, 64, 65, S, 130, 7, 199], 1, 1),
                              ([0, 1, 64, 65, S, 130, 7, 199], 1, 4),
                              ([0, 2, 60, 64, S - R, 131, 9, 100], R, 1)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.from_numpy(rng.standard_normal((B, rows, hq, d)).astype(
            np.float32)).to(dev, dtype)
        out = _dense_call(tda, q, cache, lens, 1, 0, bb, rows)
        limits = lens if rows == 1 else lens + 1
        ref = tda.dense_attention_plain(q, cache[0], cache[1], limits, 1, 0,
                                        *cache[2:])
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == q.shape
        assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("G,hkv,window", [(8, 1, 0), (8, 1, 200), (1, 2, 0),
                                          (4, 2, 0)])
def test_ragged_chunk_body_at_d256(dev, quant, G, hkv, window):
    """The chunk body's D 256 instance (one CTA an SM): Gemma-2B's MQA
    group of 8 over one kv head, with and without a window, and G 1 and
    4; chunks of 1 row, of a row tile and one more, and of several tiles,
    each within 1 bf16 ulp a row of plain, bit-identical with NaN pages
    outside the rows' ranges (``_chunk_case``)."""
    for C, pstart in ((1, 0), (128 // G + 1, 70), (300, 130)):
        _chunk_case(dev, quant, G, 64, window, C, pstart,
                    seed=230 + C + G, hkv=hkv, d=256)


# -- the MoE kernels (csrc/moe_route.cu, csrc/moe_grouped.cu) -----------------

MOE_H, MOE_I, MOE_E, MOE_K = 2048, 768, 128, 8
# tokens of each case at Qwen3-30B-A3B's widths: decode horizons of 8 and
# 32 slots, a verify of 32 x 5, a mixed dispatch of 32 + 512 rows, every
# token on the same 8 experts, only even experts live, router ties, a batch
# prefill of 2048 tokens (~128 rows an expert)
MOE_CASES = {"decode 8": 8, "decode 32": 32, "verify 32x5": 160,
             "mixed 32+512": 544, "skewed": 64, "empty experts": 24,
             "ties": 40, "prefill 2048": 2048}
# rows of one expert's group: empty, inside one n8 tile, at and past its
# edge, at and past a 32-row tile's and two's, past four
MOE_GROUP_SIZES = (0, 1, 7, 8, 9, 63, 64, 65, 129)


def _moe_logits(case, seed):
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.standard_normal((MOE_CASES[case], MOE_E))
    if case == "skewed":
        logits[:, :MOE_K] += 50.0
    elif case == "empty experts":
        logits[:, 1::2] = -1e4
    elif case == "ties":
        logits[:, 0] += 12.0
        for e in (1, 5, 9, 64):
            logits[:, e] = logits[:, 0]
    return torch.from_numpy(logits.astype(np.float32))


@pytest.fixture(scope="module")
def moe_layer():
    """One layer's experts at Qwen3-30B-A3B's widths, bf16 and int8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    from aws_k8s_ansible_provisioner_tpu_torch.models.quant import \
        quant_kernel_chunked

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {"bf16": {}, "int8": {}}
    for name, shape in (("w_gate", (MOE_E, MOE_H, MOE_I)),
                        ("w_up", (MOE_E, MOE_H, MOE_I)),
                        ("w_down", (MOE_E, MOE_I, MOE_H))):
        w = (0.02 * torch.randn(shape, generator=gen, device="cuda")
             ).bfloat16()
        out["bf16"][name] = {"kernel": w}
        q, s = quant_kernel_chunked(w, 1)
        out["int8"][name] = {"kernel": q, "scale": s}
    return out


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_route_sort_matches_plain(dev, case):
    """The route-and-sort kernel against its plain version on the same
    float32 logits: experts, offsets, sorted rows and positions exact;
    weights within one bf16 ulp (the softmax sums in another order)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe

    logits = _moe_logits(case, 300).to(dev)
    got = moe.route_sort(logits, MOE_K, True, torch.bfloat16)
    want = moe.route_sort_plain(logits, MOE_K, True, torch.bfloat16)
    torch.cuda.synchronize()
    for name in ("experts", "offsets", "row_token", "row_expert", "pos"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.weights.float() - want.weights.float()).abs().max() <= 2**-8
    if case == "ties":
        assert (got.experts[:, :5] == torch.tensor(
            [0, 1, 5, 9, 64], device=dev)).all()
    if case == "empty experts":
        counts = got.offsets[1:] - got.offsets[:-1]
        assert (counts[1::2] == 0).all()


def _grouped_pair(moe, p, x, offsets, row_src, plain):
    """The gate + up product of ``x`` (rows through ``row_src`` or none),
    then the down product of its plain result over the same offsets (rows
    through ``row_src`` again when given): the kernels or, ``plain``, the
    plain versions."""
    up = moe.grouped_gate_up_plain if plain else moe.grouped_gate_up
    down = moe.grouped_matmul_plain if plain else moe.grouped_matmul
    a = up(x, p["w_gate"], p["w_up"], offsets, row_src)
    a_ref = moe.grouped_gate_up_plain(x, p["w_gate"], p["w_up"], offsets,
                                      row_src)
    down_src = None if row_src is None else torch.arange(
        a_ref.shape[0], dtype=torch.int32, device=x.device).flip(0)
    down_in = a_ref if down_src is None else a_ref.flip(0).contiguous()
    return a, down(down_in, p["w_down"], offsets, down_src)


def _check_grouped(moe, p, x, offsets, row_src, m):
    a, y = _grouped_pair(moe, p, x, offsets, row_src, False)
    a_ref, y_ref = _grouped_pair(moe, p, x, offsets, row_src, True)
    torch.cuda.synchronize()
    assert a.shape == (m, MOE_I) and y.shape == (m, MOE_H)
    assert _rows_within_ulps(a, a_ref, m, 1.0, 0.5)
    assert _rows_within_ulps(y, y_ref, m, 1.0, 0.5)


@pytest.mark.parametrize("gather", [True, False], ids=["row_src", "rows"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_grouped_matches_plain(dev, moe_layer, quant, case, gather):
    """The grouped gate + up product (silu(g) * u) over the sorted rows
    (gathered from the tokens through ``row_src``, or the sorted rows
    themselves), then the grouped down product (its rows through a
    reversing ``row_src``, or none), against the plain per-expert loop:
    each row within one bf16 ulp of its largest value (the products sum in
    another order)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe

    p = moe_layer["int8" if quant else "bf16"]
    logits = _moe_logits(case, 301).to(dev)
    r = moe.route_sort(logits, MOE_K, True, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(302)
    x = torch.randn((logits.shape[0], MOE_H), generator=gen,
                    device=dev).bfloat16()
    m = logits.shape[0] * MOE_K
    if gather:
        _check_grouped(moe, p, x, r.offsets, r.row_token, m)
    else:
        xs = x.index_select(0, r.row_token).contiguous()
        _check_grouped(moe, p, xs, r.offsets, None, m)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("gather", [True, False], ids=["row_src", "rows"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("size", MOE_GROUP_SIZES)
def test_moe_grouped_group_sizes(dev, moe_layer, quant, size, gather, wide):
    """Groups of ``size`` rows on the first, a middle and the last expert
    and one row on another, every other expert empty: each row of both
    products within one bf16 ulp of plain (row tiles of 32 or 64 rows, n8
    tiles of 8: sizes on each side of their edges). ``wide`` adds 2048
    rows on one more expert, so that the int8 instances take their 64-row
    tiles (16 rows an expert or more on average)."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe

    counts = np.zeros(MOE_E, np.int64)
    counts[[0, 61, MOE_E - 1]] = size
    counts[5] = 1
    if wide:
        counts[90] = 16 * MOE_E
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                               .astype(np.int32)).to(dev)
    m = int(counts.sum())
    gen = torch.Generator(device="cuda").manual_seed(303 + size)
    p = moe_layer["int8" if quant else "bf16"]
    if gather:
        x = torch.randn((m + 3, MOE_H), generator=gen, device=dev).bfloat16()
        src = torch.randint(0, m + 3, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        _check_grouped(moe, p, x, offsets, src, m)
    else:
        x = torch.randn((m, MOE_H), generator=gen, device=dev).bfloat16()
        _check_grouped(moe, p, x, offsets, None, m)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_moe_grouped_graph_replays_new_offsets(dev, moe_layer, quant):
    """Both grouped products captured in one CUDA graph over a decode
    routing, then replayed after new offsets and row sources (a skewed
    routing of the same token count) are copied into the captured buffers:
    the persistent walk reads them on the device, so each replay equals
    the plain versions on the routing it was given."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe

    p = moe_layer["int8" if quant else "bf16"]
    n = 64
    gen = torch.Generator(device="cuda").manual_seed(304)
    x = torch.randn((n, MOE_H), generator=gen, device=dev).bfloat16()
    routes = []
    for i, case in enumerate(("decode 8", "skewed", "ties")):
        logits = _moe_logits(case, 305 + i)
        logits = logits.repeat(-(-n // logits.shape[0]), 1)[:n]
        routes.append(moe.route_sort(logits.to(dev).contiguous(), MOE_K,
                                     True, torch.bfloat16))
    offsets = routes[0].offsets.clone()
    src = routes[0].row_token.clone()

    def run():
        a = moe.grouped_gate_up(x, p["w_gate"], p["w_up"], offsets, src)
        return a, moe.grouped_matmul(a, p["w_down"], offsets)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a, y = run()
    m = n * MOE_K
    for r in routes[1:] + routes[:1]:
        offsets.copy_(r.offsets)
        src.copy_(r.row_token)
        graph.replay()
        a_ref = moe.grouped_gate_up_plain(x, p["w_gate"], p["w_up"],
                                          r.offsets, r.row_token)
        y_ref = moe.grouped_matmul_plain(a, p["w_down"], r.offsets)
        torch.cuda.synchronize()
        assert _rows_within_ulps(a, a_ref, m, 1.0, 0.5)
        assert _rows_within_ulps(y, y_ref, m, 1.0, 0.5)


def test_moe_kernels_refuse_shapes_they_do_not_take(dev, moe_layer):
    """E above 256, k above 32 or E, non-float32 logits; K not a multiple
    of 32 or out of 128, more than 256 experts, float32 rows, gate and up
    of different dtypes, int64 offsets: each raises before any launch."""
    from aws_k8s_ansible_provisioner_tpu_torch.ops import moe

    logits = torch.zeros((4, 300), device=dev)
    with pytest.raises(ValueError):
        moe.route_sort(logits, 8, True, torch.bfloat16)
    with pytest.raises(ValueError):
        moe.route_sort(logits[:, :128].contiguous(), 40, True,
                       torch.bfloat16)
    with pytest.raises(TypeError):
        moe.route_sort(logits[:, :128].double(), 8, True, torch.bfloat16)
    r = moe.route_sort(logits[:, :128].contiguous(), 8, True,
                       torch.bfloat16)
    p = moe_layer["bf16"]
    x = torch.zeros((4, MOE_H), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        moe.grouped_matmul(x.float(), p["w_gate"], r.offsets, r.row_token)
    with pytest.raises(ValueError):
        moe.grouped_matmul(x[:, :100].contiguous(), p["w_gate"], r.offsets,
                           r.row_token)
    with pytest.raises(ValueError):
        moe.grouped_matmul(x, p["w_gate"], r.offsets.long(), r.row_token)
    with pytest.raises(TypeError):
        moe.grouped_gate_up(x, p["w_gate"], moe_layer["int8"]["w_up"],
                            r.offsets, r.row_token)
    # out a multiple of 64 but not of 128 (the int8 tile row's 128 bytes)
    with pytest.raises(ValueError):
        moe.grouped_matmul(x, {"kernel": p["w_gate"]["kernel"][:, :, :192]
                               .contiguous()}, r.offsets, r.row_token)
    many = {"kernel": torch.zeros((300, 128, 128), dtype=torch.int8,
                                  device=dev),
            "scale": torch.ones((300, 128), device=dev)}
    with pytest.raises(ValueError):
        moe.grouped_matmul(x[:, :128].contiguous(), many,
                           torch.zeros(301, dtype=torch.int32, device=dev),
                           r.row_token)
