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
by the tolerances above.
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
    assert sorted(graphs.graphs) == [(1, False), (1, True), (3, False),
                                     (3, True)]
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
