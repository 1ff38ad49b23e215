"""The speculative verify's one-stream-per-slot body, on the CPU.

The CUDA verify kernels (``csrc/split_verify.cuh``, behind
``paged_attention_spec``/``_quant`` and ``spec_attend_dense``) give one CTA
a slot's R x G query rows of one kv head (up to 64: more take row groups)
and one split of the group's tiles, from the tile of its first row's first
visited column to the tile of its last row's last one; each row masks the
columns it would not visit on its own to -inf (adds nothing) and its
visited dead ones to -1e30, and the combine merges the split triples. Here a
plain model of that body (its tile range, split bounds, row groups and
per-row masked triples, merged by ``split_merge_plain``) is held against
the unsplit plain versions (the per-row form) and against the Pallas
kernels in interpret mode (``decode_attend_pallas_spec_paged``,
``decode_attend_pallas_spec``), on numpy-seeded float32 inputs at small
widths: R 1-6 with G 1, 2, 4, float32 and int8 K/V, window 0 and windows
whose start falls mid-page and a page apart across a slot's rows, a split
holding only columns masked for some row, and row groups.

The bf16 kernel rounds p (times the int8 V scale) to two bf16 halves for
its tensor-core P.V; the model rounds it the same way (``round_p``), on
inputs that are bf16 values (q, K and V exact in bf16, as the kernel takes
them). Tolerances: 1e-5 max abs for the float32 model (float32 sums in
another order); 3e-5 for the rounded one (hi + lo keeps p within 2^-18 of
itself, so P.V moves by at most 2^-18 x max |v| ~ 1.5e-5 at |v| <= 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.ops import pallas_attention as pa
from aws_k8s_ansible_provisioner_tpu_torch.ops import dense_attention as tda
from aws_k8s_ansible_provisioner_tpu_torch.ops import paged_attention as tpa
from aws_k8s_ansible_provisioner_tpu_torch.ops import split_kv

torch.set_num_threads(2)

TOL = 1e-5
TOL_ROUNDED = 3e-5
NEG = -1e30
L, HKV, D = 2, 2, 16
PS, MAXP = 4, 5            # paged: pages of 4 rows, so a slot's 5 rows'
#                            window starts lie up to a page apart
S, TILE = 256, 64          # dense: 4 tiles of the kernel's 64 rows
LAYER = 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_values(a):
    """``a`` rounded to bf16 values, kept as float32 (the kernel's bf16
    operands are exact)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _store(rng, shape, quant):
    """K, V (bf16 values in float32, or int8) and, int8, their scales."""
    if not quant:
        return [_bf16_values(rng.standard_normal(shape).astype(np.float32))
                for _ in range(2)] + [None, None]
    return ([rng.integers(-127, 128, shape).astype(np.int8)
             for _ in range(2)]
            + [rng.uniform(1e-3, 2.1e-2, shape[:-1]).astype(np.float32)
               for _ in range(2)])


# -- the model -----------------------------------------------------------------


def _row_tiles(rows):
    """16-row tiles of one CTA (csrc/split_verify.cuh row_tiles)."""
    t = (min(rows, split_kv.MAX_VERIFY_ROWS) + 15) // 16
    return 1 if t <= 1 else (2 if t <= 2 else 4)


def _row_groups(R, G, cta_rows=None):
    """The (first, stop) query rows of each CTA's group, rows in (r, g)
    order; ``cta_rows`` overrides the kernel's group size."""
    n = R * G
    size = cta_rows or _row_tiles(n) * 16
    return [(g0, min(g0 + size, n)) for g0 in range(0, n, size)]


class _Paged:
    """The paged verify's tile source: a slot's table row, pages of ``ps``
    rows (csrc/paged_attention.cu PagedVerifySource)."""

    def __init__(self, k, v, ks, vs, table, window):
        self.k, self.v, self.ks, self.vs = k, v, ks, vs
        self.table, self.window = table, window
        self.tile = k.shape[3]
        self.max_pages = table.shape[1]

    def pages(self, lim):
        ps = self.tile
        hi = min((lim + ps - 1) // ps - 1 if lim > 0 else 0,
                 self.max_pages - 1)
        lo = 0
        if self.window > 0:
            lo = min(max(lim - self.window, 0) // ps, hi)
        return lo, hi

    def columns(self, lim):
        """(visited, live) column ranges of a row with limit ``lim``."""
        lo, hi = self.pages(lim)
        start = lim - self.window if self.window > 0 else 0
        return (lo * self.tile, (hi + 1) * self.tile), (start, lim)

    def tiles(self, lim_first, lim_last):
        return self.pages(lim_first)[0], self.pages(lim_last)[1] + 1

    def gather(self, b, h, t0, t1):
        """Columns of tiles [t0, t1) of slot b, kv head h: their indices,
        K, V [C, D] and scales [C] (None unless int8)."""
        P = self.k.shape[1]
        pages = self.table[b, t0:t1].long().clamp(0, P - 1)
        cols = (torch.arange(t0, t1)[:, None] * self.tile
                + torch.arange(self.tile)).reshape(-1)

        def g(a):
            if a is None:
                return None
            x = a[LAYER, pages, h]
            return x.reshape((-1,) + x.shape[2:]).float()

        return cols, g(self.k), g(self.v), g(self.ks), g(self.vs)


class _Dense:
    """The dense verify's tile source: a slot's rows in 64-row tiles
    (csrc/dense_attention.cu DenseVerifySource)."""

    def __init__(self, k, v, ks, vs, window):
        self.k, self.v, self.ks, self.vs = k, v, ks, vs
        self.window, self.seq, self.tile = window, k.shape[3], TILE
        self.extent = 0

    def _wstart(self, lim):
        return lim - self.window if self.window > 0 and lim > self.window \
            else 0

    def columns(self, lim):
        start, end = self._wstart(lim), min(max(lim, 0), self.seq)
        return (start // TILE * TILE, end), (start, end)

    def tiles(self, lim_first, lim_last):
        self.extent = min(max(lim_last, 0), self.seq)
        end = (self.extent - 1) // TILE + 1 if self.extent > 0 else 0
        return self._wstart(lim_first) // TILE, end

    def gather(self, b, h, t0, t1):
        cols = torch.arange(t0 * TILE, max(t0 * TILE,
                                           min(t1 * TILE, self.extent)))

        def g(a):
            return None if a is None else a[LAYER, b, h, cols].float()

        return cols, g(self.k), g(self.v), g(self.ks), g(self.vs)


def _split_bf16(p):
    """p as the kernel's two bf16 halves: hi + lo, lo = bf16(p - hi)."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


def verify_model(q, src, lengths, splits, round_p=False, cta_rows=None,
                 record=None):
    """What the verify body computes: for each (slot, kv head, row group,
    split) the masked triples of the group's rows over the split's run of
    the group's tiles, then ``split_merge_plain`` of the splits. q
    [B, R, Hq, D] float32; ``record``, a list, collects (slot, row, split,
    m, l) for every triple. Returns [B, R, Hq, D] float32."""
    B, R, Hq, Dq = q.shape
    Hkv = src.k.shape[2]
    G = Hq // Hkv
    acc = torch.zeros((splits, B, R, Hq, Dq))
    m = torch.full((splits, B, R, Hq), NEG)
    l_sum = torch.zeros((splits, B, R, Hq))
    for b in range(B):
        lim0 = int(lengths[b]) + 1
        for h in range(Hkv):
            for g0, g1 in _row_groups(R, G, cta_rows):
                t_lo, t_end = src.tiles(lim0 + g0 // G, lim0 + (g1 - 1) // G)
                n = max(t_end - t_lo, 0)
                per = -(-n // splits)
                rows = torch.arange(g0, g1)
                r, g = rows // G, rows % G
                ranges = torch.tensor([sum(src.columns(lim0 + int(x)), ())
                                       for x in r])        # [rows, 4]
                for s in range(splits):
                    t0 = t_lo + s * per
                    t1 = max(min(t0 + per, t_lo + n), t0)
                    cols, k, v, ks, vs = src.gather(b, h, t0, t1)
                    x = (q[b, r, h * G + g] @ k.T) * (1.0 / Dq ** 0.5)
                    if ks is not None:
                        x = x * ks
                    c = cols[None, :]
                    visited = (c >= ranges[:, :1]) & (c < ranges[:, 1:2])
                    live = (c >= ranges[:, 2:3]) & (c < ranges[:, 3:])
                    x = torch.where(live, x, torch.full_like(x, NEG))
                    x = torch.where(visited, x,
                                    torch.full_like(x, float("-inf")))
                    mx = torch.full((len(rows),), NEG)
                    if len(cols):
                        mx = torch.maximum(mx, x.amax(dim=1))
                    p = torch.exp(x - mx[:, None])
                    pv = p if vs is None else p * vs
                    if round_p:
                        pv = _split_bf16(pv)
                    m[s, b, r, h * G + g] = mx
                    l_sum[s, b, r, h * G + g] = p.sum(dim=1)
                    acc[s, b, r, h * G + g] = pv @ v
                    if record is not None:
                        record += [(b, int(r[i]), s, float(mx[i]),
                                    float(p[i].sum()))
                                   for i in range(len(rows))]
    return split_kv.split_merge_plain(acc, m, l_sum, torch.float32)


# -- inputs and references -----------------------------------------------------


def _paged_inputs(B, R, G, quant, seed):
    rng = np.random.default_rng(seed)
    shape = (L, B * MAXP + 1, HKV, PS, D)
    k, v, ks, vs = _store(rng, shape, quant)
    table = (rng.permutation(B * MAXP) + 1).reshape(B, MAXP).astype(np.int32)
    q = _bf16_values(rng.standard_normal((B, R, HKV * G, D))
                     .astype(np.float32))
    return rng, q, (k, v, ks, vs), table


def _paged_refs(q, store, lengths, table, window, pallas=True):
    """(the unsplit plain version, the Pallas kernel or None) of the paged
    verify."""
    k, v, ks, vs = store
    sc = (_t(ks), _t(vs)) if ks is not None else ()
    plain = tpa.paged_attention_spec_plain(_t(q), _t(k), _t(v), _t(lengths),
                                           LAYER, _t(table), *sc,
                                           window=window)
    if not pallas:
        return plain, None
    kw = dict(pool_ks=jnp.asarray(ks), pool_vs=jnp.asarray(vs)) \
        if ks is not None else {}
    ref = pa.decode_attend_pallas_spec_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.int32(LAYER), jnp.asarray(table), interpret=True, window=window,
        **kw)
    return plain, torch.from_numpy(np.asarray(ref))


def _dense_inputs(B, R, G, quant, seed):
    rng = np.random.default_rng(seed)
    k, v, ks, vs = _store(rng, (L, B, HKV, S, D), quant)
    q = _bf16_values(rng.standard_normal((B, R, HKV * G, D))
                     .astype(np.float32))
    return rng, q, (k, v, ks, vs)


def _dense_refs(q, store, lengths, window, pallas=True):
    k, v, ks, vs = store
    sc = (_t(ks), _t(vs)) if ks is not None else (None, None)
    plain = tda.spec_attend_dense(_t(q), _t(k), _t(v), _t(lengths), LAYER,
                                  window, *sc)
    if not pallas:
        return plain, None
    kw = dict(cache_ks=jnp.asarray(ks), cache_vs=jnp.asarray(vs)) \
        if ks is not None else {}
    ref = pa.decode_attend_pallas_spec(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.int32(LAYER), chunk=32, interpret=True, window=window, **kw)
    return plain, torch.from_numpy(np.asarray(ref))


def _source(kind, store, table, window):
    k, v, ks, vs = (None if a is None else _t(a) for a in store)
    if kind == "paged":
        return _Paged(k, v, ks, vs, _t(table), window)
    return _Dense(k, v, ks, vs, window)


def _check(kind, q, store, table, lengths, window, splits_list,
           cta_rows=None, pallas=True):
    """The model at each split count (float32, and with p rounded as the
    bf16 kernel rounds it) against the unsplit plain version and, with
    ``pallas``, the Pallas kernel (each of its windows compiles anew in
    interpret mode, some seconds a call)."""
    if kind == "paged":
        plain, ref = _paged_refs(q, store, lengths, table, window, pallas)
    else:
        plain, ref = _dense_refs(q, store, lengths, window, pallas)
    refs = (plain,) if ref is None else (plain, ref)
    if ref is not None:
        np.testing.assert_allclose(plain.numpy(), ref.numpy(), rtol=0,
                                   atol=TOL)
    src = _source(kind, store, table, window)
    for splits in splits_list:
        got = verify_model(_t(q), src, lengths, splits, cta_rows=cta_rows)
        rounded = verify_model(_t(q), src, lengths, splits, round_p=True,
                               cta_rows=cta_rows)
        for want in refs:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(rounded.numpy(), want.numpy(),
                                       rtol=0, atol=TOL_ROUNDED)


# R 1-6, each G of 1, 2 and 4 twice over
RG = [(1, 1), (2, 2), (3, 4), (4, 1), (5, 2), (6, 4)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("R,G", RG)
def test_paged_verify_model_matches_plain_and_pallas(R, G, quant):
    """Pages of 4 rows; slots from length 0 to the table's last row, a
    window of 9 columns (its start mid-page, a row's start up to a page
    past row 0's) and none; 1, 3 and 6 splits (empty ones too). Pallas at
    one of the two windows (window 0 and 9 alternate over R and the KV
    type), the plain version at both."""
    B = 4
    _, q, store, table = _paged_inputs(B, R, G, quant, seed=200 + 10 * R + G)
    lengths = np.array([0, 6, 11, MAXP * PS - R], np.int32)
    for window in (0, 9):
        _check("paged", q, store, table, lengths, window, (1, 3, 6),
               pallas=(window > 0) == bool((R + quant) % 2))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("R,G", RG)
def test_dense_verify_model_matches_plain_and_pallas(R, G, quant):
    """Dense tiles of 64 rows; slots from length 0 to the cache's last row,
    a window of 70 rows (row 0's first tile partly masked, a later row's
    start a tile past it) and none; 1, 2 and 4 splits."""
    B = 5
    _, q, store = _dense_inputs(B, R, G, quant, seed=300 + 10 * R + G)
    lengths = np.array([0, 61, 130, 190, S - R], np.int32)
    for window in (0, 70):
        _check("dense", q, store, None, lengths, window, (1, 2, 4))


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("quant", [False, True])
def test_split_of_only_masked_columns_for_a_row(kind, quant):
    """With a window, rows 2-4 of a slot start a tile after row 0's start:
    with one tile a split, split 0 holds only columns those rows do not
    visit. They add nothing there (scores -inf, p = 0: the triple (0,
    -1e30, 0)), where the TPU body masks them to -1e30 (p = 1, scaled away
    by exp(-1e30 - m) = 0 at the row's first live column); the merge weighs
    the empty triple by exp(-1e30 - M) = 0 and matches plain and Pallas."""
    R, G, B = 5, 2, 2
    tile = PS if kind == "paged" else TILE
    window = 3 * tile
    # row r's window starts at lengths + 1 + r - window = tile - 2 + r
    lengths = np.array([window + tile - 3, window + 2 * tile - 3], np.int32)
    if kind == "paged":
        _, q, store, table = _paged_inputs(B, R, G, quant, seed=410)
    else:
        _, q, store = _dense_inputs(B, R, G, quant, seed=411)
        table = None
    src = _source(kind, store, table, window)
    lo, end = src.tiles(int(lengths[0]) + 1, int(lengths[0]) + R)
    splits = end - lo                       # one tile a split
    assert splits > 1
    record = []
    verify_model(_t(q), src, lengths, splits, record=record)
    first = {r: (mx, ll) for b, r, s, mx, ll in record if b == 0 and s == 0}
    neg = float(np.float32(NEG))
    assert all(first[r] == (neg, 0.0) for r in (2, 3, 4))
    assert all(first[r][0] > neg for r in (0, 1))
    _check(kind, q, store, table, lengths, window, (splits,))


@pytest.mark.parametrize("kind", ["paged", "dense"])
@pytest.mark.parametrize("quant", [False, True])
def test_row_groups_beyond_one_cta(kind, quant):
    """R x G beyond one CTA's rows: 9 x 8 = 72 rows (groups of 64 and 8),
    and 5 x 4 rows in groups of 16 (groups that cut a draft row's heads),
    each group over its own tiles."""
    for R, G, cta_rows in ((9, 8, None), (5, 4, 16)):
        assert len(_row_groups(R, G, cta_rows)) == 2
        B = 3
        if kind == "paged":
            _, q, store, table = _paged_inputs(B, R, G, quant, seed=420 + R)
            lengths = np.array([0, 7, MAXP * PS - R], np.int32)
        else:
            _, q, store = _dense_inputs(B, R, G, quant, seed=430 + R)
            table = None
            lengths = np.array([0, 100, S - R], np.int32)
        # Pallas at the 72 rows (its interpret mode compiles per shape)
        _check(kind, q, store, table, lengths, 2 * PS + 1, (1, 3),
               cta_rows=cta_rows, pallas=cta_rows is None)


@pytest.mark.parametrize("R,G", [(1, 1), (5, 2), (5, 4), (9, 8), (16, 4)])
def test_row_groups_of_the_kernel(R, G):
    """One group up to 64 rows (16-row tiles 1, 2 or 4), groups of 64
    beyond; ``split_kv.verify_groups`` counts them as the kernel does."""
    groups = _row_groups(R, G)
    assert len(groups) == split_kv.verify_groups(R, G)
    assert groups[0][0] == 0 and groups[-1][1] == R * G
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert all(g1 - g0 <= split_kv.MAX_VERIFY_ROWS for g0, g1 in groups)


@pytest.mark.parametrize("window", [0, 9, 13])
def test_slot_range_is_the_union_of_its_rows_ranges(window):
    """A group's tiles run from its first row's first visited page to its
    last row's last, and every row's visited pages lie in that run: no
    page outside the rows' own ranges is read, nor a table entry past
    max_pages."""
    R = 5
    src = _Paged(torch.zeros((L, 1, 1, PS, D)), None, None, None,
                 torch.zeros((1, MAXP), dtype=torch.int32), window)
    for length in range(MAXP * PS - R + 1):
        lo, end = src.tiles(length + 1, length + R)
        assert 0 <= lo < end <= MAXP
        union = set()
        for r in range(R):
            lim = length + 1 + r
            p_lo, p_hi = tpa._live_pages(torch.tensor([lim]), PS, MAXP,
                                         window)
            union |= set(range(int(p_lo), int(p_hi) + 1))
            (vlo, vhi), _ = src.columns(lim)
            assert (vlo // PS, vhi // PS - 1) == (int(p_lo), int(p_hi))
        assert union == set(range(lo, end))
