"""The port's prefix cache and host KV tier against the JAX package.

Pool level, on the same calls and numpy-seeded pools: ``PagePool``'s chain
index, evictable LRU and refcount sharing give the JAX allocator's page ids,
chain keys and stats; ``HostTier``'s spill log, two-level lookup, LRU under
byte pressure and fetch verification behave as the JAX tier's;
``gather_pages`` and ``restore_pages`` move whole pages bit for bit as the
JAX functions do (float32, bfloat16, int8 with its scales), the restore in
place; ``kv_cache.copy_prefix`` copies the JAX function's rows, also over
sequence shards.

Engine level, tiny_qwen3 at float32 on the JAX ``init_params`` weights
(scaled so that greedy streams do not collapse), both engines at the same
configuration with the prefix cache on: the scenarios of
tests/test_prefix_cache.py (dense, and the four host-tier ones) and the
prefix scenarios of tests/test_paged_engine.py (pages shared with no copy,
a resume hitting its own pages, a follow-up turn hitting generated pages),
with float32 and int8 KV (the JAX engine's int8 row write needs 32-row
pages) and the decode pipeline at 1 and 0, plus a tiny_mistral paged case.
Streams must be byte-identical to the JAX engine's, the port's counts equal
to the JAX metrics, and no page left live after the drain. Also: a restore
keeps every pool leaf's storage; the hit, spill and restore paths read
nothing from the device on the host; a slot finished under a dispatch in
flight publishes none of its garbage rows; a decode growth that reclaims
pages spills them first.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aws_k8s_ansible_provisioner_tpu.config import ServingConfig as JServing
from aws_k8s_ansible_provisioner_tpu.config import tiny_mistral as jax_mistral
from aws_k8s_ansible_provisioner_tpu.config import tiny_qwen3 as jax_qwen3
from aws_k8s_ansible_provisioner_tpu.models.layers import init_params
from aws_k8s_ansible_provisioner_tpu.serving import kv_cache as jkvc
from aws_k8s_ansible_provisioner_tpu.serving import paged_kv as jkv
from aws_k8s_ansible_provisioner_tpu.serving.engine import Engine as JEngine
from aws_k8s_ansible_provisioner_tpu.serving.engine import Request as JRequest
from aws_k8s_ansible_provisioner_tpu_torch.config import ModelConfig
from aws_k8s_ansible_provisioner_tpu_torch.config import \
    ServingConfig as TServing
from aws_k8s_ansible_provisioner_tpu_torch.models.convert import \
    from_jax_params
from aws_k8s_ansible_provisioner_tpu_torch.serving import kv_cache as tkvc
from aws_k8s_ansible_provisioner_tpu_torch.serving import paged_kv as tkv
from aws_k8s_ansible_provisioner_tpu_torch.serving import server as tserver
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Engine as TEngine
from aws_k8s_ansible_provisioner_tpu_torch.serving.engine import \
    Request as TRequest

torch.set_num_threads(2)

PS = 8


# ---------------------------------------------------------------------------
# pool level
# ---------------------------------------------------------------------------


def test_config_defaults_match_jax():
    """The port's default ServingConfig serves the prefix cache and the
    host tier as the JAX default does."""
    t, j = TServing(), JServing()
    for name in ("prefix_cache", "prefix_cache_min_len",
                 "prefix_cache_payback_rows", "prefix_reuse_min_pages",
                 "kv_host_tier_bytes"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.prefix_cache is True and t.kv_host_tier_bytes == 256 * 2**20


def test_chain_keys_equal_jax():
    toks = [tuple(range(i * PS, (i + 1) * PS)) for i in range(3)]
    jk = tk = None
    for t in toks:
        jk = jkv.PagePool.chain_key(jk, t)
        tk = tkv.PagePool.chain_key(tk, t)
        assert jk == tk


def _pools_agree(ref, got):
    assert got.free_pages == ref.free_pages
    assert got.pages_in_use == ref.pages_in_use
    assert got.stats() == ref.stats()


def test_page_pool_chain_lookup_and_eviction_match_jax():
    """tests/test_paged_kv.py's chain lookup, the evictable LRU, retain of
    an evictable page and reclaim from the LRU front, on both allocators:
    the same ids, matches and stats after every step."""
    ref, got = jkv.PagePool(7, PS, first_page=1), \
        tkv.PagePool(7, PS, first_page=1)
    prompt = list(range(20))              # 2 full pages + a tail of 4
    pages = ref.alloc(3)
    assert got.alloc(3) == pages
    rk = tk = None
    for i in range(2):
        toks = tuple(prompt[i * PS:(i + 1) * PS])
        rk = ref.index_page(pages[i], rk, toks)
        tk = got.index_page(pages[i], tk, toks)
        assert rk == tk
    other = prompt[:PS] + [99] * PS
    for p in (prompt, other, prompt[:PS - 1], [5] * 20):
        assert got.lookup_prefix(p) == ref.lookup_prefix(p)
    assert got.lookup_prefix(prompt) == (pages[:2], 2 * PS, [])
    for pool in (ref, got):
        pool.release_all(pages)
    _pools_agree(ref, got)
    assert got.free_pages == 6 and got.stats()["pages_evictable"] == 2
    assert got.lookup_prefix(prompt) == ref.lookup_prefix(prompt)
    for pool in (ref, got):
        for pid in pages[:2]:
            pool.retain(pid)
    _pools_agree(ref, got)
    assert got.pages_in_use == 2
    for pool in (ref, got):
        pool.release_all(pages[:2])
        pool.retain(pages[1])              # refcount sharing on a live page
        pool.retain(pages[1])
        pool.release(pages[1])
    _pools_agree(ref, got)
    assert ref.alloc(5) == got.alloc(5)   # 4 free + the LRU front page
    _pools_agree(ref, got)
    assert got.lookup_prefix(prompt) == ref.lookup_prefix(prompt) \
        == ([], 0, [])
    for pool in (ref, got):
        pool.release(pages[1])
    _pools_agree(ref, got)


ENTRY_BYTES = 2 * 2 * 2 * PS * 16 * 4
SHAPES = {"k": (2, 2, PS, 16), "v": (2, 2, PS, 16)}


def _park(tier, key, toks, torch_side):
    """One page into the tier: the JAX tier's ``put``; the port's spill of
    a one-page burst into a slot (its slots taken on first use)."""
    entry = _entry(toks, torch_side)
    if not torch_side:
        tier.put(key, toks, entry, ENTRY_BYTES)
        return
    if tier._slots is None:
        tier.reserve({n: torch.zeros((a.shape[0], 1) + a.shape[1:])
                      for n, a in entry.items()})
    tier.spill([(0, key, toks)], {n: a[:, None] for n, a in entry.items()},
               ENTRY_BYTES)


def _entry(toks, torch_side):
    k = np.full((2, 2, PS, 16), float(toks[0]), np.float32)
    if torch_side:
        return {"k": torch.from_numpy(k), "v": torch.from_numpy(k + 1)}
    return {"k": k, "v": k + 1}


def test_host_tier_spill_log_and_two_level_lookup_match_jax():
    """Reclaiming indexed pages logs them with their chain identity; once
    their payloads sit in the tier the lookup returns them as the host
    extension past the resident chain; without a tier the walk is off."""
    sides = []
    for mod, torch_side in ((jkv, False), (tkv, True)):
        p = mod.PagePool(4, PS, first_page=1)
        p.host_tier = mod.HostTier(10 * ENTRY_BYTES)
        prompt = list(range(3 * PS))
        pages = p.alloc(3)
        key, keys = None, []
        for i in range(3):
            key = p.index_page(pages[i], key,
                               tuple(prompt[i * PS:(i + 1) * PS]))
            keys.append(key)
        p.release_all(pages)
        p.alloc(2)
        log = list(p.evicted_log)
        assert [(k, t) for _, k, t in log] == [
            (k, tuple(prompt[i * PS:(i + 1) * PS]))
            for i, k in enumerate(keys[:2])]
        for _, k, t in log:
            _park(p.host_tier, k, t, torch_side)
        p.evicted_log = []
        found = p.lookup_prefix(prompt)
        assert found == ([], 0, keys[:2])
        p.host_tier = None
        assert p.lookup_prefix(prompt) == ([], 0, [])
        sides.append((log, found, p.stats()))
    assert sides[0] == sides[1]


def test_host_tier_lru_under_byte_pressure_matches_jax():
    stats = []
    for mod, torch_side in ((jkv, False), (tkv, True)):
        tier = mod.HostTier(2 * ENTRY_BYTES)
        toks = [tuple(range(i * PS, (i + 1) * PS)) for i in range(3)]
        keys = [mod.PagePool.chain_key(None, t) for t in toks]
        for k, t in zip(keys, toks):
            _park(tier, k, t, torch_side)
        assert len(tier) == 2 and tier.dropped_lru == 1
        assert not tier.contains(keys[0], toks[0])
        assert tier.contains(keys[1], toks[1])
        assert tier.used_bytes == 2 * ENTRY_BYTES
        # a fetch bumps recency: entry 1 outlives the next insert
        assert tier.fetch(keys[1], toks[1], SHAPES) is not None
        t3 = tuple(range(90, 90 + PS))
        _park(tier, mod.PagePool.chain_key(None, t3), t3, torch_side)
        assert tier.contains(keys[1], toks[1])
        assert not tier.contains(keys[2], toks[2])
        stats.append(tier.stats())
    assert stats[0] == stats[1]


def test_host_tier_fetch_verifies_and_drops_as_jax():
    """A token mismatch or a truncated payload never comes back from fetch:
    the entry is dropped and counted; a clean entry round-trips."""
    stats = []
    for mod, torch_side in ((jkv, False), (tkv, True)):
        tier = mod.HostTier(10 * ENTRY_BYTES)
        toks = tuple(range(PS))
        key = mod.PagePool.chain_key(None, toks)
        _park(tier, key, toks, torch_side)
        assert tier.fetch(key, tuple(range(1, PS + 1)), SHAPES) is None
        assert tier.dropped_invalid == 1 and len(tier) == 0
        _park(tier, key, toks, torch_side)
        tier.corrupt(key)
        assert tier.fetch(key, toks, SHAPES) is None
        assert tier.used_bytes == 0 and tier.dropped_invalid == 2
        _park(tier, key, toks, torch_side)
        got = tier.fetch(key, toks, SHAPES)
        np.testing.assert_array_equal(np.asarray(got["k"]),
                                      _entry(toks, False)["k"])
        # a missing leaf fails the check too
        assert tier.fetch(key, toks, {**SHAPES, "ks": (2, 2, PS)}) is None
        stats.append(tier.stats())
    assert stats[0] == stats[1]


def _numpy_pool(seed, quant, dtype=np.float32, L=2, P=13, H=2, D=16):
    rng = np.random.default_rng(seed)
    shape = (L, P, H, PS, D)
    if quant:
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.random(shape[:-1]).astype(np.float32),
                "vs": rng.random(shape[:-1]).astype(np.float32)}
    return {"k": rng.standard_normal(shape).astype(dtype),
            "v": rng.standard_normal(shape).astype(dtype)}


def _to_torch(pool, dtype):
    return {n: torch.from_numpy(a.copy()).to(
        dtype if a.dtype == np.float32 and n in ("k", "v") else
        torch.from_numpy(a[:0]).dtype) for n, a in pool.items()}


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_gather_restore_bit_identical_to_jax(kind):
    """gather_pages then restore_pages into other physical pages, on one
    numpy pool through both packages: the gathered payloads and the pool
    after the restore equal the JAX ones bit for bit; the port's restore
    writes every leaf in place (same storage) and touches no other page."""
    quant = kind == "int8"
    base = _numpy_pool(3, quant)
    tdtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    jdtype = jnp.bfloat16 if kind == "bfloat16" else jnp.float32
    jpool = {n: jnp.asarray(a).astype(jdtype) if n in ("k", "v")
             and not quant else jnp.asarray(a) for n, a in base.items()}
    tpool = _to_torch(base, tdtype)
    src, dst = [2, 5, 9], [11, 3, 7]
    jdata = jkv.gather_pages(jpool, src)
    tdata = tkv.gather_pages(tpool, src)
    for n in base:
        assert tuple(tdata[n].shape) == jdata[n].shape
        np.testing.assert_array_equal(tdata[n].float().numpy(),
                                      np.asarray(jdata[n]).astype(np.float32))
        # one page's slice is contiguous (its copy to the host)
        assert tdata[n][:, 1].is_contiguous()
    before = {n: a.clone() for n, a in tpool.items()}
    ptrs = {n: a.data_ptr() for n, a in tpool.items()}
    jout = jkv.restore_pages(jpool, dst, jdata)
    tout = tkv.restore_pages(tpool, dst, tdata)
    assert tout is tpool
    for n in base:
        assert tpool[n].data_ptr() == ptrs[n]
        np.testing.assert_array_equal(tpool[n].float().numpy(),
                                      np.asarray(jout[n]).astype(np.float32))
        assert torch.equal(tpool[n][:, dst], before[n][:, src])
        rest = [p for p in range(tpool[n].shape[1]) if p not in dst]
        assert torch.equal(tpool[n][:, rest], before[n][:, rest])


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_spill_then_upload_restores_pages_bit_identical(quant):
    """HostTier.spill of a gathered burst, fetch, upload_pages and
    restore_pages: the pages come back bit-identical, scales included."""
    pool = _to_torch(_numpy_pool(5, quant), torch.float32)
    shapes = {n: (a.shape[0],) + tuple(a.shape[2:]) for n, a in pool.items()}
    nbytes = sum(a[:, 0].numel() * a.element_size() for a in pool.values())
    tier = tkv.HostTier(100 * nbytes)
    with pytest.raises(RuntimeError):
        tier.spill([], tkv.gather_pages(pool, [4]), nbytes)
    with pytest.raises(ValueError):
        tkv.HostTier(nbytes - 1).reserve(pool)
    tier.reserve(pool)
    assert len(tier._free_slots) == 100
    src = [4, 8]
    log = [(pid, tkv.PagePool.chain_key(None, (pid,) * PS), (pid,) * PS)
           for pid in src]
    want = {n: a[:, src].clone() for n, a in pool.items()}
    tier.spill(log, tkv.gather_pages(pool, src), nbytes)
    for a in pool.values():
        a.zero_()
    entries = [tier.fetch(k, t, shapes) for _, k, t in log]
    assert all(e is not None for e in entries)
    tkv.restore_pages(pool, [1, 12], tkv.upload_pages(entries, "cpu"))
    for n, a in pool.items():
        assert torch.equal(a[:, [1, 12]], want[n])
    assert tier.stats()["spilled_pages"] == 2
    # a tier of one slot: the second page of a burst evicts the first and
    # takes its slot
    small = tkv.HostTier(nbytes + 1)
    small.reserve(pool)
    small.spill(log, tkv.gather_pages(pool, [1, 12]), nbytes)
    assert len(small) == 1 and small.dropped_lru == 1
    assert small.fetch(*log[0][1:], shapes) is None
    got = small.fetch(*log[1][1:], shapes)
    for n, a in pool.items():
        assert torch.equal(got[n], a[:, 12])


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_copy_prefix_matches_jax_and_shards(quant):
    """The dense copy of rows [0, n) from one slot to another: the JAX
    function's cache bit for bit; over 2 and 4 sequence shards, the shards
    of the unsharded result."""
    rng = np.random.default_rng(7)
    L, B, H, S, D = 2, 3, 2, 32, 16
    shape = (L, B, H, S, D)
    if quant:
        base = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.random(shape[:-1]).astype(np.float32),
                "vs": rng.random(shape[:-1]).astype(np.float32)}
    else:
        base = {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    for n_rows in (0, 13, 32):
        ref = jkvc.copy_prefix({n: jnp.asarray(a) for n, a in base.items()},
                               2, 0, n_rows)
        cache = {n: torch.from_numpy(a.copy()) for n, a in base.items()}
        ptrs = {n: a.data_ptr() for n, a in cache.items()}
        out = tkvc.copy_prefix(cache, 2, 0, n_rows)
        for n in base:
            assert out[n].data_ptr() == ptrs[n]
            np.testing.assert_array_equal(out[n].numpy(), np.asarray(ref[n]))
        for sp in (2, 4):
            s_local = S // sp
            shards = [{n: torch.from_numpy(
                a[:, :, :, i * s_local:(i + 1) * s_local].copy())
                for n, a in base.items()} for i in range(sp)]
            tkvc.copy_prefix(shards, 2, 0, n_rows)
            for n in base:
                whole = torch.cat([s[n] for s in shards], dim=3)
                np.testing.assert_array_equal(whole.numpy(),
                                              np.asarray(ref[n]))


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


def _scaled(params, by=8):
    def go(node):
        return {k: go(v) if isinstance(v, dict) else
                v * by if k == "kernel" else v for k, v in node.items()}

    out = go(params)
    out["embed"] = {"weight": out["embed"]["weight"] * by}
    return out


def _model(jcfg):
    jp = _scaled(init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, tcfg, from_jax_params(jax.tree.map(np.asarray, jp),
                                           tcfg)


@pytest.fixture(scope="module")
def qwen():
    return _model(jax_qwen3())


@pytest.fixture(scope="module")
def mistral():
    return _model(jax_mistral())


def _engines(model, **serving):
    """Both engines at one configuration. The admission-pressure
    preemption (a running request preempted after the queue head waited
    ``admission_preempt_after_s`` of wall time for pages) is a wall-clock
    rule that would make the CPU runs differ from run to run: it is off on
    both sides (``tests/test_torch_lifecycle.py`` holds it)."""
    jcfg, jp, tcfg, tp = model
    je = JEngine(jcfg, jp, JServing(weights_dtype="bf16",
                                    admission_preempt_after_s=0.0,
                                    **serving))
    te = TEngine(tcfg, tp, TServing(weights_dtype="bf16",
                                    admission_preempt_after_s=0.0,
                                    **serving),
                 device="cpu")
    return je, te


def _drain(eng):
    for _ in range(20000):
        if not eng.step():
            return
    raise AssertionError("engine did not go idle")


def _wave(eng, prompts, max_tokens=6, **req):
    cls = JRequest if isinstance(eng, JEngine) else TRequest
    req = req or dict(ignore_eos=True)
    reqs = [eng.submit(cls(prompt_ids=list(p), max_tokens=max_tokens,
                           **req)) for p in prompts]
    _drain(eng)
    return [r.generated for r in reqs]


COUNTS = ("prefix_cache_hits", "prefix_tokens_reused", "kv_spill_bytes",
          "kv_restore_bytes", "kv_restore_dropped")


def _jax_counts(je):
    m = je.metrics
    out = {name: int(getattr(m, name).total()) for name in COUNTS}
    for tier in ("hbm", "host", "miss"):
        out[f"prefix_tier_hits_{tier}"] = int(
            m.prefix_tier_hits.value(tier=tier))
    return out


def _port_counts(te):
    names = COUNTS + tuple(f"prefix_tier_hits_{t}"
                           for t in ("hbm", "host", "miss"))
    return {name: int(te.counts[name]) for name in names}


def _check_drained(je, te):
    """No page live after the drain, on both sides; the port's counts equal
    the JAX metrics."""
    assert _port_counts(te) == _jax_counts(je)
    if te.paged:
        st = te.allocator.stats()
        assert st["pages_live"] == 0
        assert st["pages_free"] + st["pages_evictable"] == st["pages_total"]
        for a in je.allocators:
            assert a.stats()["pages_live"] == 0


def _both(model, scenario, **serving):
    """Run ``scenario(engine)`` on both engines; its streams must be
    identical and the counts equal. Returns (port engine, streams)."""
    je, te = _engines(model, **serving)
    want = scenario(je)
    got = scenario(te)
    assert got == want
    assert all(g for g in got)
    _check_drained(je, te)
    return te, got


def _rand(rng, n):
    return rng.integers(2, 128, n).tolist()


DENSE = dict(max_decode_slots=4, max_cache_len=128, prefill_buckets=(16, 64),
             dtype="float32", prefix_cache_min_len=8,
             prefix_cache_payback_rows=1, paged=False, derived_seed=0)


def _dense_hit(eng):
    rng = np.random.default_rng(0)
    shared = _rand(rng, 24)
    a, b = shared + _rand(rng, 6), shared + _rand(rng, 9)
    return _wave(eng, [a]) + _wave(eng, [b])


def _dense_active_source(eng):
    rng = np.random.default_rng(1)
    shared = _rand(rng, 20)
    a, b = shared + _rand(rng, 4), shared + _rand(rng, 7)
    cls = JRequest if isinstance(eng, JEngine) else TRequest
    ra = eng.submit(cls(prompt_ids=a, max_tokens=10, ignore_eos=True))
    eng.step()                  # a's slot is now a live prefix source
    rb = eng.submit(cls(prompt_ids=b, max_tokens=10, ignore_eos=True))
    _drain(eng)
    return [ra.generated, rb.generated]


def _dense_interleaved(eng):
    rng = np.random.default_rng(2)
    shared = _rand(rng, 16)
    a, c, b = shared + _rand(rng, 3), _rand(rng, 5), shared + _rand(rng, 5)
    return (_wave(eng, [a], 8) + _wave(eng, [c], 8) + _wave(eng, [b], 8))


def _dense_short(eng):
    rng = np.random.default_rng(3)
    shared = _rand(rng, 4)
    return _wave(eng, [shared + _rand(rng, 6)]) + \
        _wave(eng, [shared + _rand(rng, 8)])


def _dense_stale(eng):
    rng = np.random.default_rng(4)
    old, new = _rand(rng, 12), _rand(rng, 12)
    return _wave(eng, [old]) + _wave(eng, [new]) + \
        _wave(eng, [old + _rand(rng, 3)])


def _dense_same_round(eng):
    rng = np.random.default_rng(6)
    p, a = _rand(rng, 16), _rand(rng, 14)
    b = p + _rand(rng, 5)
    return _wave(eng, [p]) + _wave(eng, [a, b]) + _wave(eng, [b, a])


def _dense_burst(eng):
    rng = np.random.default_rng(7)
    shared = _rand(rng, 16)
    p = shared + _rand(rng, 3)
    burst = [shared + _rand(rng, k) for k in (4, 5, 6)]
    return _wave(eng, [p]) + _wave(eng, burst)


def _dense_chunked_suffix(eng):
    rng = np.random.default_rng(5)
    shared = _rand(rng, 24)
    return _wave(eng, [shared + _rand(rng, 4)]) + \
        _wave(eng, [shared + _rand(rng, 40)])


def _dense_same_slot(eng):
    rng = np.random.default_rng(9)
    a = _rand(rng, 20)
    return _wave(eng, [a]) + _wave(eng, [a + _rand(rng, 6)])


def _dense_payback(eng):
    rng = np.random.default_rng(8)
    shared = _rand(rng, 24)
    return _wave(eng, [shared + _rand(rng, 4)]) + \
        _wave(eng, [shared + _rand(rng, 6)])


# scenario, serving overrides, expected (hits, tokens reused)
DENSE_CASES = {
    "hit": (_dense_hit, {}, (1, 24)),
    "active_source": (_dense_active_source, {}, (1, 20)),
    "interleaved_decodes": (_dense_interleaved, {}, (1, 16)),
    "short_prefix": (_dense_short, {}, (0, 0)),
    "stale_on_reuse": (_dense_stale, dict(max_decode_slots=1), (0, 0)),
    "same_round": (_dense_same_round, dict(max_decode_slots=2), None),
    "burst": (_dense_burst, {}, (0, 0)),
    "chunked_suffix": (_dense_chunked_suffix, dict(prefill_chunk=16),
                       (1, 24)),
    "same_slot": (_dense_same_slot, dict(max_decode_slots=1,
                                         prefix_cache_payback_rows=256),
                  (1, 20)),
    "payback_gate": (_dense_payback, dict(prefix_cache_payback_rows=256),
                     (0, 0)),
}


@pytest.mark.parametrize("pipeline", [1, 0], ids=["pipe", "sync"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_prefix_scenarios_match_jax(qwen, case, kv_dtype, pipeline):
    """tests/test_prefix_cache.py's dense scenarios: the same streams and
    hit counts as the JAX engine (and the hits that file expects)."""
    scenario, over, expect = DENSE_CASES[case]
    te, _ = _both(qwen, scenario, **{**DENSE, **over, "kv_dtype": kv_dtype,
                                     "decode_pipeline": pipeline})
    if expect is not None:
        assert (te.counts["prefix_cache_hits"],
                te.counts["prefix_tokens_reused"]) == expect
    if case == "burst":
        # the burst prefilled in one batched dispatch, no hit
        assert te.counts["prefill_dispatches"] == 2


def test_dense_prefix_is_invisible_in_the_stream(qwen):
    """A hit's stream equals the stream of a port engine without the
    prefix cache (the oracle of tests/test_prefix_cache.py)."""
    over = dict(DENSE, prefill_chunk=16)
    on = TEngine(qwen[2], qwen[3], TServing(weights_dtype="bf16", **over),
                 device="cpu")
    off = TEngine(qwen[2], qwen[3], TServing(weights_dtype="bf16",
                                            prefix_cache=False, **over),
                  device="cpu")
    assert _dense_chunked_suffix(on) == _dense_chunked_suffix(off)
    assert on.counts["prefix_cache_hits"] == 1
    assert off.counts["prefix_cache_hits"] == 0


@pytest.mark.parametrize("sp", [2, 4])
def test_dense_prefix_copy_per_shard_under_sp(qwen, sp):
    """The dense engine over sp sequence shards: the hit's rows are copied
    shard by shard, and the streams and counts equal the unsharded dense
    engine's (which the JAX engine's match above)."""
    from aws_k8s_ansible_provisioner_tpu_torch.config import MeshConfig
    from aws_k8s_ansible_provisioner_tpu_torch.parallel.mesh import make_mesh

    over = dict(DENSE, prefill_chunk=16)
    one = TEngine(qwen[2], qwen[3], TServing(weights_dtype="bf16", **over),
                  device="cpu")
    sharded = TEngine(qwen[2], qwen[3], TServing(weights_dtype="bf16",
                                                **over),
                      device="cpu", mesh=make_mesh(MeshConfig(sp=sp),
                                                   ["cpu"] * sp))
    assert isinstance(sharded.cache, list) and len(sharded.cache) == sp
    assert _dense_chunked_suffix(sharded) == _dense_chunked_suffix(one)
    assert _port_counts(sharded) == _port_counts(one)
    assert sharded.counts["prefix_tokens_reused"] == 24


def _paged(kv_dtype, **over):
    """tests/test_paged_engine.py's engine: 8 slots of 64 rows, pages of 8
    (int8 KV: of 32, the JAX engine's int8 row write, over 128 rows)."""
    ps = 32 if kv_dtype == "int8" else PS
    kw = dict(max_decode_slots=8, max_cache_len=64 if ps == PS else 128,
              page_size=ps, prefill_buckets=(8, 16, 32) if ps == PS
              else (8, 16, 32, 64, 128), dtype="float32",
              paged=True, kv_dtype=kv_dtype, derived_seed=0)
    kw.update(over)
    return kw


def _shared_pages(ps):
    def run(eng):
        seed = list(range(2, 2 + 2 * ps))             # exactly 2 full pages
        out = _wave(eng, [seed], 1)
        # while the first holds its pages, the follow-up shares them
        cls = JRequest if isinstance(eng, JEngine) else TRequest
        long = eng.submit(cls(prompt_ids=seed, max_tokens=12,
                              ignore_eos=True))
        eng.step()
        follow = eng.submit(cls(prompt_ids=seed + [50, 51, 52],
                                max_tokens=1, ignore_eos=True))
        _drain(eng)
        return out + [long.generated, follow.generated]
    return run


def _followup_turn(ps, n_new=12):
    def run(eng):
        prompt = [3, 1, 4, 1, 5, 9, 2, 6] * (ps // PS)
        first = _wave(eng, [prompt], n_new)
        follow = prompt + first[0] + [7, 7, 7]
        return first + _wave(eng, [follow], 4)
    return run


@pytest.mark.parametrize("pipeline", [1, 0], ids=["pipe", "sync"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_paged_shared_pages_no_copy_match_jax(qwen, kv_dtype, pipeline):
    """A follow-up sharing two full pages hits them: twice while the first
    request still holds them (refcount shared, not copied)."""
    kw = _paged(kv_dtype, kv_pool_pages=24, decode_pipeline=pipeline)
    ps = kw["page_size"]
    te, _ = _both(qwen, _shared_pages(ps), **kw)
    assert te.counts["prefix_tokens_reused"] >= 2 * ps


@pytest.mark.parametrize("pipeline", [1, 0], ids=["pipe", "sync"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_followup_turn_hits_generated_pages_match_jax(qwen, kv_dtype,
                                                      pipeline):
    """Turn 2 re-sends turn 1's prompt and answer: it hits past the prompt
    page into the generated ones (the finish indexed them up to the last
    written row)."""
    kw = _paged(kv_dtype, decode_pipeline=pipeline)
    ps = kw["page_size"]
    te, _ = _both(qwen, _followup_turn(ps, n_new=12 if ps == PS else 40),
                  **kw)
    assert te.counts["prefix_tokens_reused"] >= 2 * ps


def _preempt_resume(ps, n_new):
    def run(eng):
        cls = JRequest if isinstance(eng, JEngine) else TRequest
        r = eng.submit(cls(prompt_ids=[3] * 4, max_tokens=n_new,
                           ignore_eos=True))
        for _ in range(400):
            eng.step()
            if len(r.generated) >= 2 * ps:
                break
        assert len(r.generated) >= 2 * ps
        slot = next(s for s, q in enumerate(eng.slot_req) if q is r)
        eng._preempt(slot)
        _drain(eng)
        return [r.generated]
    return run


@pytest.mark.parametrize("pipeline", [1, 0], ids=["pipe", "sync"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_preempted_resume_hits_its_own_pages_match_jax(qwen, kv_dtype,
                                                       pipeline):
    """A preemption indexes the victim's written pages: its resume
    re-prefills only the tail, and the stream is the JAX engine's (and the
    length asked for)."""
    kw = _paged(kv_dtype, kv_pool_pages=24, decode_pipeline=pipeline)
    ps = kw["page_size"]
    n_new = 40 if ps == PS else 100
    te, got = _both(qwen, _preempt_resume(ps, n_new), **kw)
    assert te.counts["preemptions"] == 1
    assert te.counts["prefix_tokens_reused"] >= ps
    assert len(got[0]) == n_new


def test_mistral_followup_turn_matches_jax(mistral):
    """tiny_mistral (window 8): the follow-up turn's suffix attends through
    the window over shared pages."""
    te, _ = _both(mistral, _followup_turn(PS, n_new=20),
                  **_paged("auto", max_cache_len=128))
    assert te.counts["prefix_tokens_reused"] >= 3 * PS


# ---------------------------------------------------------------------------
# the host tier
# ---------------------------------------------------------------------------


def _tier(kv_dtype, **over):
    """tests/test_prefix_cache.py's host-tier engine: a pool too small to
    keep A's pages through B and C (10 pages of 8; int8: 3 of 32)."""
    ps = 32 if kv_dtype == "int8" else PS
    kw = dict(max_decode_slots=4, max_cache_len=64, page_size=ps,
              prefill_buckets=(8, 16, 32, 64), dtype="float32", paged=True,
              kv_pool_pages=10 if ps == PS else 3, kv_host_tier_bytes=1 << 22,
              kv_dtype=kv_dtype, derived_seed=0)
    kw.update(over)
    return kw


def _tier_prompts(seed):
    rng = np.random.default_rng(seed)
    return _rand(rng, 33), _rand(rng, 33), _rand(rng, 33)


def _spill_restore(eng):
    a, b, c = _tier_prompts(11)
    return [_wave(eng, [p])[0] for p in (a, b, c, a)]


TIER = [("auto", 1), ("auto", 0), ("int8", 1), ("int8", 0)]
TIER_IDS = ["f32-pipe", "f32-sync", "int8-pipe", "int8-sync"]


@pytest.mark.parametrize("kv_dtype,pipeline", TIER, ids=TIER_IDS)
def test_host_tier_spill_restore_match_jax(qwen, kv_dtype, pipeline):
    """A's pages spill while B and C run; A again restores them from the
    host and gives its cold stream."""
    te, got = _both(qwen, _spill_restore,
                    **_tier(kv_dtype, decode_pipeline=pipeline))
    assert got[3] == got[0]
    assert te.counts["prefix_tier_hits_host"] >= 1
    assert te.counts["kv_spill_bytes"] > 0
    assert te.counts["kv_restore_bytes"] > 0
    assert te.host_tier.restored_pages > 0


def test_restore_is_copied_out_before_its_slots_are_refilled(qwen):
    """A tier of 5 page slots: the admission that restores A's pages also
    reclaims pages of the pool and spills them, evicting the entries it
    has just fetched and refilling their slots; the restore still gives
    A's cold stream (its payloads were copied out first) and the JAX
    engine's counts."""
    _, _, tcfg, _ = qwen
    page = tcfg.num_layers * 2 * tcfg.num_kv_heads * PS * tcfg.head_dim * 4
    te, got = _both(qwen, _spill_restore,
                    **_tier("auto", kv_host_tier_bytes=5 * page))
    assert te._page_bytes == page
    assert got[3] == got[0]
    assert te.counts["prefix_tier_hits_host"] == 1
    assert te.host_tier.dropped_lru > 0


def test_host_tier_zero_budget_byte_identity(qwen):
    """kv_host_tier_bytes=0: no tier, no host hit, no spill, and the same
    streams as the engine with the tier (and the JAX engine's)."""
    te_off, off = _both(qwen, _spill_restore,
                        **_tier("auto", kv_host_tier_bytes=0))
    assert te_off.host_tier is None
    assert "host_tier" not in te_off.allocator.stats()
    assert te_off.counts["kv_spill_bytes"] == 0
    assert te_off.counts["prefix_tier_hits_host"] == 0
    on = TEngine(qwen[2], qwen[3], TServing(weights_dtype="bf16",
                                           **_tier("auto")), device="cpu")
    assert _spill_restore(on) == off


@pytest.mark.parametrize("over", ["no-prefix-cache", "budget-below-a-page"])
def test_no_host_tier_without_the_cache_or_a_page_of_budget(qwen, over):
    """The tier serves the prefix cache: with the cache off, or a budget
    that holds no page, the engine takes no host memory and has no tier;
    A's second run re-prefills (no host hit) and gives its cold stream."""
    _, _, tcfg, _ = qwen
    page = tcfg.num_layers * 2 * tcfg.num_kv_heads * PS * tcfg.head_dim * 4
    kw = (dict(prefix_cache=False) if over == "no-prefix-cache"
          else dict(kv_host_tier_bytes=page - 1))
    eng = TEngine(qwen[2], qwen[3], TServing(weights_dtype="bf16",
                                            **_tier("auto", **kw)),
                  device="cpu")
    assert eng.host_tier is None and eng.allocator.host_tier is None
    got = _spill_restore(eng)
    assert got[3] == got[0]
    assert eng.counts["prefix_tier_hits_host"] == 0
    assert eng.counts["kv_spill_bytes"] == 0
    assert eng.allocator.stats()["pages_live"] == 0


@pytest.mark.parametrize("kv_dtype,pipeline", TIER, ids=TIER_IDS)
def test_host_tier_restore_races_concurrent_hit(qwen, kv_dtype, pipeline):
    """Two admissions restoring the same evicted prefix back to back: each
    takes its own pages, both streams are the cold one, and after the drain
    every page was released exactly once."""
    a, b, c = _tier_prompts(13)

    def run(eng):
        cold = [_wave(eng, [p])[0] for p in (a, b, c)]
        return cold + _wave(eng, [a, a])

    # int8's 32-row pages: A's one full page must pass the burst gate
    te, got = _both(qwen, run, **_tier(
        kv_dtype, decode_pipeline=pipeline,
        prefix_reuse_min_pages=1 if kv_dtype == "int8" else 2))
    assert got[3] == got[4] == got[0]
    assert te.counts["prefix_tier_hits_host"] >= 1


def _corrupt_all(tier):
    for key in list(tier._entries):
        tier.corrupt(key)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_corrupted_host_entry_drops_not_corrupts(qwen, kv_dtype):
    """Every host entry truncated before A comes back (the JAX chaos
    kv_offload_error, through HostTier.corrupt on both sides): the fetch
    drops it, counts it, and A re-prefills to its cold stream."""
    a, b, c = _tier_prompts(14)

    def run(eng):
        out = [_wave(eng, [p])[0] for p in (a, b, c)]
        assert eng.host_tier.spilled_pages > 0
        _corrupt_all(eng.host_tier)
        return out + _wave(eng, [a])

    te, got = _both(qwen, run, **_tier(kv_dtype))
    assert got[3] == got[0]
    assert te.counts["kv_restore_dropped"] >= 1
    assert te.host_tier.dropped_invalid >= 1
    assert te.counts["prefix_tier_hits_host"] == 0


def test_reclaim_under_growth_spills_before_the_write(qwen):
    """A's indexed pages sit in the LRU while B's decode grows page by
    page: the growth reclaims A's oldest pages and spills them before the
    dispatch that writes them; A then restores them and gives its cold
    stream (pipelined, as the JAX engine)."""
    rng = np.random.default_rng(21)
    a, b = _rand(rng, 33), _rand(rng, 8)
    spilled_by_admission = {TEngine: 0}
    before_a = {}

    def run(eng):
        out = _wave(eng, [a]) + _wave(eng, [b], 50)
        if isinstance(eng, TEngine):
            before_a["growth"] = eng.counts["kv_spill_bytes"]
            before_a["admission"] = spilled_by_admission[TEngine]
        return out + _wave(eng, [a])

    kw = _tier("auto", decode_pipeline=1)
    je, te = _engines(qwen, **kw)
    admit = TEngine._paged_admit

    def counting(self, *args):
        before = self.counts["kv_spill_bytes"]
        out = admit(self, *args)
        spilled_by_admission[TEngine] += self.counts["kv_spill_bytes"] \
            - before
        return out

    want = run(je)
    TEngine._paged_admit = counting
    try:
        got = run(te)
    finally:
        TEngine._paged_admit = admit
    assert got == want and got[2] == got[0]
    _check_drained(je, te)
    # everything spilled before A came back was spilled by B's growth
    assert before_a["growth"] > 0 and before_a["admission"] == 0
    assert te.counts["prefix_tier_hits_host"] == 1


def test_pipelined_finish_publishes_no_garbage_row(qwen):
    """A request finishing with a decode dispatch in flight: that dispatch
    keeps writing the slot's rows from len(ids) - 1 on through its stale
    table. The finish indexes only pages below that row, so a follow-up
    turn that hits the generated pages gives the JAX engine's stream and
    the stream of an engine without the prefix cache."""
    kw = _paged("auto", decode_pipeline=1, decode_horizon=4)
    at_finish = []
    finish = TEngine._finish

    def watched(self, slot):
        at_finish.append(self._inflight is not None)
        return finish(self, slot)

    run = _followup_turn(PS, n_new=13)
    je, te = _engines(qwen, **kw)
    want = run(je)
    TEngine._finish = watched
    try:
        got = run(te)
    finally:
        TEngine._finish = finish
    assert got == want
    _check_drained(je, te)
    assert at_finish[0], "turn 1 did not finish under a dispatch in flight"
    assert te.counts["prefix_tokens_reused"] >= 2 * PS
    cold = TEngine(qwen[2], qwen[3], TServing(weights_dtype="bf16",
                                             prefix_cache=False, **kw),
                   device="cpu")
    assert run(cold) == got


class _HostRead(RuntimeError):
    pass


_READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__int__",
          "__float__")


def test_hit_spill_and_restore_read_nothing_on_the_host(qwen, monkeypatch):
    """Under the pipeline: the admission of a prompt that hits resident
    pages, restores host pages and reclaims (spills) others, and a decode
    growth that spills, run with the tensor's host reads patched to raise.
    The restore writes the pool in place."""
    a, b, c = _tier_prompts(17)
    te = TEngine(qwen[2], qwen[3], TServing(
        weights_dtype="bf16", **_tier("auto", decode_pipeline=1)),
        device="cpu")
    for p in (a, b, c):
        _wave(te, [p])
    ptrs = {n: t.data_ptr() for n, t in te.cache.items()}
    spilled = te.counts["kv_spill_bytes"]
    te.submit(TRequest(prompt_ids=a, max_tokens=6, ignore_eos=True))

    def raiser(name):
        def read(self, *args, **kw):
            raise _HostRead(f"Tensor.{name} on the prefix path")
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, raiser(name))
    batch, chunk_next = te._admit()
    te._start_chunk(*chunk_next)
    te._ensure_pages(3 * PS)
    monkeypatch.undo()
    assert not batch and chunk_next[4] > 0
    assert te.counts["prefix_tier_hits_host"] == 1
    assert te.counts["kv_restore_bytes"] > 0
    assert te.counts["kv_spill_bytes"] > spilled
    assert {n: t.data_ptr() for n, t in te.cache.items()} == ptrs
    _drain(te)
    assert te.allocator.stats()["pages_live"] == 0


def test_server_flags_reach_the_serving_config(monkeypatch):
    """--no-prefix-cache and --kv-host-tier-bytes set the ServingConfig
    the server builds its engine from (defaults: on, 256 MiB)."""
    seen = []

    def build_state(serving, **kw):
        seen.append(serving)
        raise SystemExit(0)

    monkeypatch.setattr(tserver, "build_state", build_state)
    for argv, want in (([], (True, 256 * 2**20)),
                       (["--no-prefix-cache", "--kv-host-tier-bytes", "0"],
                        (False, 0)),
                       (["--kv-host-tier-bytes", "1048576"],
                        (True, 1 << 20))):
        with pytest.raises(SystemExit):
            tserver.main(["--model", "tiny-qwen3", "--device", "cpu"] + argv)
        assert (seen[-1].prefix_cache, seen[-1].kv_host_tier_bytes) == want
