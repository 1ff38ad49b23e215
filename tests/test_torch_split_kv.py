"""The split-KV decode attention's split and combine, on the CPU.

The CUDA kernels give each (query row, kv head) ``splits`` CTAs over equal
runs of the row's tiles and combine their float32 triples
(``ops/split_kv.py``). Here the plain version of what the split CTAs leave
(``split_triples_plain``, from scores formed as the kernels form them) is
combined by the plain combine (``split_merge_plain``) and held against the
unsplit plain attention and against the JAX Pallas kernels in interpret
mode, on numpy-seeded float32 inputs: a paged row at limit 0 (ROADMAP C2),
a dense row at length 0 (C8, C11), window rows whose first tile is partly
masked, empty splits, int8 pools and caches. Tolerance: max abs 1e-5 (all
sides accumulate in float32 in different orders). The split count depends
on shapes only.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as tda
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv
from aws_k8s_ansible_provisioner_tpu_torch.ops.attention import merge_stats

torch.set_num_threads(2)

TOL = 1e-5
NEG = -1e30
L, HKV, HQ, D = 2, 2, 4, 16
PS, MAXP = 8, 6            # paged
S, TILE = 320, 64          # dense: 5 tiles of the kernel's 64 rows


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kv(rng, shape, quant):
    """K, V (float32, or int8 values) and, int8, their scales [shape[:-1]]."""
    if not quant:
        return [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)] + [None, None]
    return ([rng.integers(-127, 128, shape).astype(np.int8)
             for _ in range(2)]
            + [rng.uniform(1e-3, 2.1e-2, shape[:-1]).astype(np.float32)
               for _ in range(2)])


def _scores(q, k, ks):
    """(q / sqrt(D)) . k (int8: times the K scale): q [N, Hkv, G, D], k
    [N, Hkv, C, D] -> [N, Hkv, G, C]."""
    s = torch.einsum("nkgd,nkcd->nkgc", q.float() / D ** 0.5, k.float())
    return s if ks is None else s * ks[:, :, None, :]


def _paged_triples(q, pk, pv, pks, pvs, limits, layer, table, window,
                   splits):
    """The triples the paged kernel's split CTAs leave: row n's pages
    lo..hi, split s over the s-th run of them; live columns
    [limit - window, limit), the others -1e30."""
    N = q.shape[0]
    lo, hi = tpa._live_pages(limits, PS, table.shape[1], window)
    n_vis = int((hi - lo).max()) + 1
    c = lo[:, None] + torch.arange(n_vis)                       # [N, n_vis]
    visited = c <= hi[:, None]
    pages = table.long().gather(1, torch.minimum(c, hi[:, None]))

    def gather(pool):                 # [N, Hkv, n_vis * PS, (D)]
        g = pool[layer][pages].movedim(2, 1)
        return g.reshape((N, HKV, n_vis * PS) + g.shape[4:]).float()

    ks = None if pks is None else gather(pks)
    s = _scores(q.reshape(N, HKV, HQ // HKV, D), gather(pk), ks)
    col = (c[:, :, None] * PS + torch.arange(PS)).reshape(N, -1)
    lim = limits.long()[:, None]
    live = (col < lim) & ((col >= lim - window) if window else True)
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG))
    tile = torch.where(visited, c - lo[:, None], -1).repeat_interleave(PS, 1)
    n_tiles = hi - lo + 1
    return split_kv.split_triples_plain(
        s, gather(pv), tile, n_tiles, splits,
        None if pvs is None else gather(pvs)), n_tiles


def _dense_triples(q, ck, cv, cks, cvs, limits, layer, window, splits):
    """The triples the dense kernel's split CTAs leave: packed row (b, r)
    with limit limits[b] + r visits the 64-row tiles from its window
    start's to its last row; live columns from the window start on."""
    B, R = q.shape[:2]
    lim = (limits.long()[:, None] + torch.arange(R)).reshape(B * R)
    ext = lim.clamp(0, S)
    wstart = (lim - window).clamp_min(0) if window else torch.zeros_like(lim)
    lo = wstart // TILE
    n_tiles = torch.where(ext > 0, (ext - 1) // TILE + 1 - lo, 0)
    col = torch.arange(S)[None, :]
    tile = torch.where((col >= lo[:, None] * TILE) & (col < ext[:, None]),
                       col // TILE - lo[:, None], -1)

    def rows(a):                      # [B * R, Hkv, S, (D)] of slot b
        return a[layer].repeat_interleave(R, dim=0).float()

    ks = None if cks is None else rows(cks)
    s = _scores(q.reshape(B * R, HKV, HQ // HKV, D), rows(ck), ks)
    s = torch.where((col >= wstart[:, None])[:, None, None], s,
                    torch.full_like(s, NEG))
    return split_kv.split_triples_plain(
        s, rows(cv), tile, n_tiles, splits,
        None if cvs is None else rows(cvs)), n_tiles


def _assert_empty_splits_exact(triples, n_tiles, splits):
    """Every split past its row's tiles is exactly (0, -1e30, 0); returns
    how many there are."""
    acc, m, l_sum = triples
    begin, end = split_kv.split_bounds(n_tiles, splits)
    empty = (begin >= end).T                                 # [splits, N]
    assert not acc[empty].any() and not l_sum[empty].any()
    assert bool((m[empty] == NEG).all())
    return int(empty.sum())


# -- the split count and the tile runs ----------------------------------------


@pytest.mark.parametrize("rows,hkv,tiles,sms", [
    (32, 8, 32, 132), (16, 8, 128, 132), (288, 8, 32, 132),
    (528, 8, 128, 132), (160, 8, 32, 132), (80, 8, 128, 132),
    (4, 8, 512, 132), (4, 8, 128, 132), (1, 1, 1, 132), (1, 1, 4000, 132),
    (0, 8, 32, 132), (3, 2, 6, 4), (6, 2, 5, 1)])
def test_split_count_depends_on_shapes_only(rows, hkv, tiles, sms):
    """At least 1, never more splits than tiles or MAX_SPLITS, enough CTAs
    for CTAS_PER_SM per SM where the tiles allow, and a pure function of
    the shapes."""
    n = split_kv.split_count(rows, hkv, tiles, sms)
    assert n == split_kv.split_count(rows, hkv, tiles, sms)
    assert 1 <= n <= max(1, min(tiles, split_kv.MAX_SPLITS))
    if rows * hkv and n < min(tiles, split_kv.MAX_SPLITS):
        assert rows * hkv * n >= split_kv.CTAS_PER_SM * sms
    if n > 1:
        assert rows * hkv * (n - 1) < split_kv.CTAS_PER_SM * sms


def test_split_counts_at_the_serving_shapes():
    """The H100's 132 SMs: Qwen3 decode (32 rows x 8 kv heads, 32 pages)
    3 splits; Mistral decode (16 x 8, 128 pages) 5; the ragged entries (288
    and 528 rows) and the verifies (160 and 80 rows) 1; the dense decode of
    4 slots at 27,000 rows (8 kv heads, 512 tiles) 17."""
    got = [split_kv.split_count(r, 8, t, 132) for r, t in
           ((32, 32), (16, 128), (288, 32), (528, 128), (160, 32),
            (80, 128), (4, 512))]
    assert got == [3, 5, 1, 1, 1, 1, 17]


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_split_bounds_cover_each_tile_once(splits):
    """Every tile of a row in exactly one split, the splits in order, runs
    of equal length but the last; a split past the row's tiles is empty."""
    n_tiles = torch.arange(0, 21)
    begin, end = split_kv.split_bounds(n_tiles, splits)
    for n in range(21):
        seen = [t for s in range(splits)
                for t in range(int(begin[n, s]), int(end[n, s]))]
        assert seen == list(range(n))
        per = -(-n // splits)
        sizes = (end[n] - begin[n]).clamp_min(0).tolist()
        assert all(x == per for x in sizes[:n // per if per else 0])


# -- the paged kernel (K1) ----------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_paged_split_merge_matches_unsplit_and_pallas(quant, window, splits):
    """Rows at limit 0 (C2: the mean of V over page table[n, 0]), one
    column, page edges, the full table, and with a window rows whose first
    page is partly masked; at 5 splits most rows have empty splits."""
    rng = np.random.default_rng(50 + splits + 7 * quant + window)
    B = 8
    P = B * MAXP + 1
    pk, pv, pks, pvs = _kv(rng, (L, P, HKV, PS, D), quant)
    table = (rng.permutation(B * MAXP) + 1).reshape(B, MAXP).astype(np.int32)
    limits = np.array([0, 1, PS, PS + 1, MAXP * PS, 29, 3 * PS + 5, 0],
                      np.int32)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    tq, tk, tv, tl, tt = (_t(a) for a in (q, pk, pv, limits, table))
    tks, tvs = (None, None) if not quant else (_t(pks), _t(pvs))
    triples, n_tiles = _paged_triples(tq, tk, tv, tks, tvs, tl, 1, tt,
                                      window, splits)
    got = split_kv.split_merge_plain(*triples, torch.float32)
    ref = tpa.paged_attention_plain(tq, tk, tv, tl, 1, tt, tks, tvs, window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=TOL)
    kw = {} if not quant else {"pool_ks": jnp.asarray(pks),
                               "pool_vs": jnp.asarray(pvs)}
    jax_out = np.asarray(pa.ragged_attend_pallas_paged(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(limits), jnp.int32(1), jnp.asarray(table),
        interpret=True, window=window, **kw))
    # the Pallas int8 body is compared on live rows, as the int8 parity
    # tests compare it (tests/test_torch_kv_quant.py)
    rows = limits > 0 if quant else slice(None)
    np.testing.assert_allclose(got.numpy()[rows], jax_out[rows], rtol=0,
                               atol=TOL)
    # C2: the limit-0 rows average V over their first page
    for n in np.flatnonzero(limits == 0):
        v = tv[1, int(table[n, 0])].float()
        if quant:
            v = v * tvs[1, int(table[n, 0])][..., None]
        mean = v.mean(dim=1).repeat_interleave(HQ // HKV, dim=0)
        np.testing.assert_allclose(got[n].numpy(), mean.numpy(), rtol=0,
                                   atol=TOL)
    assert (_assert_empty_splits_exact(triples, n_tiles, splits) > 0) \
        == (splits > 1)


# -- the dense kernel (K4, K5, K7) --------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("splits", [1, 2, 4, 7])
@pytest.mark.parametrize("R", [1, 3])
def test_dense_split_merge_matches_unsplit_and_pallas(quant, window, splits,
                                                      R):
    """Lengths 0 (C8: zeros; C11: K5 gives K4's zeros too), one row, 64-row
    tile edges, the full cache, window rows whose first tile is partly
    masked; at 7 splits (more than the 5 tiles) some splits are empty. R =
    1 is the decode (K4; K5 is the same launch), R = 3 the verify (K7)."""
    rng = np.random.default_rng(60 + splits + 7 * quant + window + R)
    B = 8
    ck, cv, cks, cvs = _kv(rng, (L, B, HKV, S, D), quant)
    lengths = np.array([0, 1, TILE, TILE + 1, 200,
                        S if R == 1 else S - R, 130, 257], np.int32)
    limits = lengths if R == 1 else lengths + 1
    q = rng.standard_normal((B, R, HQ, D)).astype(np.float32)
    tq, tk, tv = _t(q), _t(ck), _t(cv)
    tks, tvs = (None, None) if not quant else (_t(cks), _t(cvs))
    triples, n_tiles = _dense_triples(tq, tk, tv, tks, tvs, _t(limits), 1,
                                      window, splits)
    got = split_kv.split_merge_plain(*triples, torch.float32) \
        .reshape(B, R, HQ, D)
    ref = tda.dense_attention_plain(tq, tk, tv, _t(limits), 1, window, tks,
                                    tvs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=TOL)
    kw = {} if not quant else {"cache_ks": jnp.asarray(cks),
                               "cache_vs": jnp.asarray(cvs)}
    args = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(lengths), jnp.int32(1))
    if R == 1:
        jax_out = pa.decode_attend_pallas_layer(
            *args, chunk=16, interpret=True, window=window, bblock=1, **kw)
        assert not got[0].any()                      # length 0: zeros
        k5 = tda.decode_attend_dense(tq, tk, tv, _t(lengths), 1, window,
                                     tks, tvs, bblock=4)
        np.testing.assert_allclose(got.numpy(), k5.numpy(), rtol=0,
                                   atol=TOL)
    else:
        jax_out = pa.decode_attend_pallas_spec(
            *args, chunk=16, interpret=True, window=window, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=0,
                               atol=TOL)
    # the decode's length-0 row has only empty splits; at 7 splits every
    # row has some (a row has at most 5 tiles)
    empty = _assert_empty_splits_exact(triples, n_tiles, splits)
    assert empty >= (B * R if splits == 7 else R == 1)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_stats_split_merge_matches_k6(quant, splits):
    """K6's split form: the combined raw triple against the K6 plain
    version and the Pallas stats kernel (interpret): m, l and acc / l
    within 1e-5; a slot with no row in the shard exactly (0, -1e30,
    0)."""
    rng = np.random.default_rng(70 + splits + 7 * quant)
    B = 6
    ck, cv, cks, cvs = _kv(rng, (L, B, HKV, S, D), quant)
    lengths = np.array([0, 1, TILE, 150, S, 0], np.int32)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    tq, tk, tv, tlen = _t(q), _t(ck), _t(cv), _t(lengths)
    tks, tvs = (None, None) if not quant else (_t(cks), _t(cvs))
    acc, m, l_sum = split_kv.split_merge_plain(
        *_dense_triples(tq, tk, tv, tks, tvs, tlen, 0, 0, splits)[0])
    refs = [tda.dense_attention_stats_plain(tq, tk, tv, tlen, 0, tks, tvs)]
    kw = {} if not quant else {"cache_ks": jnp.asarray(cks),
                               "cache_vs": jnp.asarray(cvs)}
    refs.append(tuple(torch.from_numpy(np.array(x)) for x in
                      pa.decode_attend_pallas_layer(
                          jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                          jnp.asarray(lengths), jnp.int32(0), chunk=16,
                          interpret=True, return_stats=True, **kw)))
    live = lengths > 0
    for racc, rm, rl in refs:
        np.testing.assert_allclose(m[live].numpy(), rm[live].numpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(l_sum[live].numpy(), rl[live].numpy(),
                                   rtol=TOL, atol=0)
        scale = rl[live][..., None].numpy()
        np.testing.assert_allclose(acc[live].numpy() / scale,
                                   racc[live].numpy() / scale, rtol=0,
                                   atol=TOL)
    assert not acc[~live].any() and not l_sum[~live].any()
    assert bool((m[~live] == NEG).all())


# -- the combine --------------------------------------------------------------


def test_merge_keeps_a_wholly_masked_split_where_merge_stats_drops_it():
    """C2 against the sp merge's rule: a row whose only visited page is
    wholly masked leaves one split with m = -1e30 and p = 1 on every column
    (l = page rows, acc = the sum of V); the other splits are empty. The
    combine returns the mean of V, as the unsplit kernel does;
    ops/attention.merge_stats, which weighs m <= -1e29 as 0, would return
    zeros."""
    rng = np.random.default_rng(80)
    v = torch.from_numpy(rng.standard_normal((PS, D)).astype(np.float32))
    acc = torch.zeros((3, 1, 1, D))
    m = torch.full((3, 1, 1), NEG)
    l_sum = torch.zeros((3, 1, 1))
    acc[1, 0, 0], l_sum[1] = v.sum(0), PS
    got = split_kv.split_merge_plain(acc, m, l_sum, torch.float32)[0, 0]
    np.testing.assert_allclose(got.numpy(), v.mean(0).numpy(), rtol=0,
                               atol=TOL)
    assert not merge_stats(acc[:, 0], m[:, 0], l_sum[:, 0], "cpu").any()


def test_merge_of_one_visited_split_is_that_split_exactly():
    """One visited split beside empty ones: weight exp(0) = 1, the empty
    ones add exactly 0, so the combine reproduces the unsplit result bit
    for bit."""
    rng = np.random.default_rng(81)
    acc = torch.zeros((4, 2, 3, D))
    m = torch.full((4, 2, 3), NEG)
    l_sum = torch.zeros((4, 2, 3))
    acc[2] = torch.from_numpy(rng.standard_normal((2, 3, D))
                              .astype(np.float32))
    m[2] = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    l_sum[2] = torch.from_numpy(rng.uniform(1, 9, (2, 3)).astype(np.float32))
    a, mm, ll = split_kv.split_merge_plain(acc, m, l_sum)
    assert torch.equal(a, acc[2]) and torch.equal(mm, m[2]) \
        and torch.equal(ll, l_sum[2])


def test_split_merge_on_cpu_takes_the_plain_version():
    """CPU tensors: the wrapper returns the plain combine (into ``out`` or
    as a triple) and counts no launch."""
    rng = np.random.default_rng(82)
    acc = torch.from_numpy(rng.standard_normal((3, 4, D)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    l_sum = torch.from_numpy(rng.uniform(1, 5, (3, 4)).astype(np.float32))
    before = split_kv.launch_counts()
    out = torch.empty((4, D), dtype=torch.bfloat16)
    assert split_kv.split_merge(acc, m, l_sum, out=out) is out
    assert torch.equal(out, split_kv.split_merge_plain(acc, m, l_sum,
                                                       torch.bfloat16))
    for got, want in zip(split_kv.split_merge(acc, m, l_sum),
                         split_kv.split_merge_plain(acc, m, l_sum)):
        assert torch.equal(got, want)
    assert split_kv.launch_counts() == before


def test_launch_plan_keeps_one_workspace_per_stream(monkeypatch):
    """One split: no workspace. More: acc, m and l at the offsets of
    [splits, rows, hq, d] and twice [splits, rows, hq] float32 in one
    buffer, kept for the next launch on the same stream (and host thread),
    grown for a larger one, and separate for another stream."""
    monkeypatch.setattr(split_kv, "sm_count", lambda device: 132)
    monkeypatch.setattr(split_kv, "_workspaces", {})
    cpu = torch.device("cpu")
    assert split_kv.launch_plan(288, 8, 32, 16, 128, cpu, 7) == \
        (1, (None, None, None))
    assert split_kv._workspaces == {}
    splits, (acc, m, l_sum) = split_kv.launch_plan(32, 8, 32, 16, 128, cpu,
                                                   7)
    assert splits == split_kv.split_count(32, 8, 32, 132) == 3
    n = splits * 32 * 16
    assert (m - acc, l_sum - m) == (4 * n * 128, 4 * n)
    (buf,) = split_kv._workspaces.values()
    assert buf.dtype == torch.float32 and buf.numel() == n * 130
    assert buf.data_ptr() == acc
    assert split_kv.launch_plan(16, 8, 32, 16, 128, cpu, 7)[1][0] == acc
    assert split_kv.launch_plan(32, 8, 32, 16, 128, cpu, 8)[1][0] != acc
    assert split_kv.launch_plan(4, 8, 512, 32, 128, cpu, 7)[0] == 17
    assert split_kv._workspaces[(cpu, 7, threading.get_ident())].numel() \
        == 17 * 4 * 32 * 130
    assert len(split_kv._workspaces) == 2
