"""The port's prefix cache (ROADMAP A7a) against the JAX package's on the
CPU: the radix trie and the ``KVPool`` sharing / copy-on-write / rollback
methods call for call against the reference's, the engine's device page
copy of every pool leaf, and whole serving runs with the cache on
(``torch_spec_parity.py`` has the engine check)."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_config as jax_get_config
from repro.serving.kv_pool import KVPool as JaxKVPool
from repro.serving.prefix_cache import PrefixCache as JaxPrefixCache
from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import PhaseAwareConfig

from torch_spec_parity import check_engine

N_SLOTS, N_PAGES, PAGE = 3, 16, 4


def _pools(kv_dtype="f32"):
    """The reference's and the port's KVPool on reduced llama2-7b."""
    jcfg = dataclasses.replace(jax_get_config("llama2-7b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("llama2-7b").reduced(),
                              dtype="float32")
    return (JaxKVPool(jcfg, n_slots=N_SLOTS, n_pages=N_PAGES, page_size=PAGE,
                      kv_dtype=kv_dtype),
            KVPool(cfg, n_slots=N_SLOTS, n_pages=N_PAGES, page_size=PAGE,
                   kv_dtype=kv_dtype, device="cpu"))


def _state(pool):
    return [(p.table.tolist(), p.lens.tolist(), p.ref.tolist(),
             p.external.tolist(), list(p.free)) for p in pool.pools]


def _same(pools):
    a, b = (_state(p) for p in pools)
    assert a == b
    for pool in pools:
        for p in pool.pools:
            p.check_invariants()


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_matches_reference(seed):
    """Random publishes, matches (attached to a slot), evictions and
    releases over prompts that share heads: every return value, the
    stats and the pool after every call equal the reference's."""
    rng = np.random.default_rng(seed)
    pools = _pools()
    caches = (JaxPrefixCache(PAGE, pools[0].shareable_capacity()),
              PrefixCache(PAGE, pools[1].shareable_capacity()))
    heads = [rng.integers(0, 50, 12).astype(np.int32) for _ in range(2)]
    holder = [None] * N_SLOTS
    for _ in range(60):
        op = rng.choice(["publish", "attach", "evict", "release"])
        free = [s for s in range(N_SLOTS) if holder[s] is None]
        if op in ("publish", "attach") and free:
            s = free[0]
            head = heads[int(rng.integers(2))]
            toks = np.concatenate([head[:int(rng.integers(4, 13))],
                                   rng.integers(0, 50, int(rng.integers(0, 9)))
                                   .astype(np.int32)])
            if op == "attach":
                got = [c.match(toks, max_tokens=len(toks) - 1)
                       for c in caches]
                assert got[0] == got[1]
                matched, pages = got[1]
                if matched:
                    for pool in pools:
                        pool.attach(s, pages, matched)
            grown = [pool.grow(s, len(toks)) for pool in pools]
            assert grown[0] == grown[1]
            if grown[1]:
                holder[s] = toks
                if op == "publish":
                    added = [c.insert(toks, pool, s)
                             for c, pool in zip(caches, pools)]
                    assert added[0] == added[1]
        elif op == "evict":
            n = int(rng.integers(1, 4))
            freed = [c.evict(pool, n) for c, pool in zip(caches, pools)]
            assert freed[0] == freed[1]
        elif op == "release":
            s = int(rng.integers(N_SLOTS))
            holder[s] = None
            for pool in pools:
                pool.release(s)
        assert caches[0].stats() == caches[1].stats()
        assert len(caches[0]) == len(caches[1])
        _same(pools)
    freed = [c.flush(pool) for c, pool in zip(caches, pools)]
    assert freed[0] == freed[1]
    _same(pools)


# op codes, growth and sharing weighted up so COW and freeing rollbacks
# occur in most examples: 0 grow, 1 attach (an occupied slot is released
# first), 2 ensure_writable, 3 cow_deficit, 4 truncate, 5 release, 6 pin a
# page for the cache, 7 drop a pin
_OPS = st.lists(st.tuples(st.sampled_from([0, 0, 0, 1, 1, 2, 2, 3, 4, 4, 5,
                                           6, 7]),
                          st.integers(0, N_SLOTS - 1),
                          st.integers(0, 24), st.integers(0, 24)),
                min_size=8, max_size=48)


@settings(derandomize=True, database=None, max_examples=80, deadline=None)
@given(_OPS)
def test_kv_pool_interleaving_matches_reference(ops):
    """Any interleaving of grow, attach, ensure_writable (COW), cow_deficit,
    truncate, release and cache pins (retain / release_ref) gives the same
    return values, block tables, refcounts and free pages as the
    reference's pool."""
    pools = _pools()
    pins = []                                    # (run, page) held
    for op, s, a, b in ops:
        ref = pools[0]
        cur = ref.len_of(s)
        if op == 0:
            args, name = (s, cur + a % 9), "grow"
        elif op == 1:
            donors = [d for d in range(N_SLOTS)
                      if d != s and ref.len_of(d) >= PAGE]
            if not donors:
                continue
            if cur:
                for pool in pools:
                    pool.release(s)
            d = donors[a % len(donors)]
            n = PAGE * (1 + b % (ref.len_of(d) // PAGE))
            args, name = (s, ref.prefix_pages(d, n), n), "attach"
        elif op in (2, 3):
            if not cur:
                continue
            start = a % cur
            end = min(start + 1 + b % 6, cur)
            args = (s, start, end)
            name = "ensure_writable" if op == 2 else "cow_deficit"
        elif op == 4:
            args, name = (s, a % (cur + 1)), "truncate"
        elif op == 5:
            args, name = (s,), "release"
        elif op == 6:
            if cur < PAGE:
                continue
            run = a % len(ref.pools)
            page = ref.prefix_pages(s, PAGE)[run][0]
            pins.append((run, page))
            args, name = (run, page), "retain"
        else:
            if not pins:
                continue
            args, name = pins.pop(a % len(pins)), "release_ref"
        got = [getattr(pool, name)(*args) for pool in pools]
        assert got[0] == got[1], name
        _same(pools)


def test_truncate_and_rollback_bound_match_reference():
    """The reference's rollback targets (tests/test_speculative.py:459-504)
    on both pools: truncate frees only whole rejected pages and never a
    page a sharer or the cache still holds; a full-attention plan can roll
    back anywhere the pool addresses."""
    pools = _pools()
    for pool in pools:
        assert pool.grow(0, 10)                  # 3 pages
        assert pool.truncate(0, 9) == 0
        assert pool.truncate(0, 8) == len(pool.pools)
        with pytest.raises(ValueError):
            pool.truncate(0, 9)
        pages = pool.prefix_pages(0, 8)
        pool.attach(1, pages, 8)                 # slot 1 shares both pages
        for r, pp in enumerate(pages):
            pool.retain(r, pp[0])                # the cache pins page 0
        assert pool.truncate(1, 0) == 0          # shared: nothing frees
        assert pool.truncate(0, 4) == len(pool.pools)
        pool.release(0)
        for r, pp in enumerate(pages):
            assert int(pool.pools[r].ref[pp[0]]) == 1
            pool.release_ref(r, pp[0])
        assert pool.free_pages() == N_PAGES
        assert pool.rollback_bound() == pool.length_bound
    _same(pools)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "int4"])
def test_cow_copies_every_leaf(kv_dtype):
    """A write into a shared page (a prompt equal to a cached prefix
    writing its last token) copies the page first: every leaf of the run's
    pool — K, V and, quantized, their scale pages — holds at the new page
    what the old page holds, the sharer keeps the old page, and the pool's
    invariants hold."""
    cfg = dataclasses.replace(get_config("llama2-7b").reduced(),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, params, ServeConfig(
        max_batch=2, paged=True, page_size=8, n_pages=8, kv_dtype=kv_dtype,
        prefix_cache=True, phase=PhaseAwareConfig(prefill_chunk=8)),
        device="cpu")
    gen = torch.Generator().manual_seed(1)
    for cache in eng.cache:
        for leaf in cache.values():
            if leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
            else:
                leaf.copy_(torch.randint(0, 100, leaf.shape, generator=gen))
    toks = np.arange(16, dtype=np.int32)
    assert eng.pool.grow(0, 16)
    eng.prefix.insert(toks, eng.pool, 0)
    matched, pages = eng.prefix.match(toks)
    assert matched == 16
    eng.pool.attach(1, pages, matched)
    before = [{k: v.clone() for k, v in c.items()} for c in eng.cache]
    assert eng._ensure_writable(1, 15, 16)
    assert eng.cow_copies == len(eng.pool.pools)
    for r, p in enumerate(eng.pool.pools):
        old, new = pages[r][1], int(p.table[1, 1])
        assert new != old and int(p.table[0, 1]) == old
        for name, leaf in eng.cache[r].items():
            assert torch.equal(leaf[:, new], leaf[:, old]), name
            assert torch.equal(leaf[:, old], before[r][name][:, old]), name
        p.check_invariants()


def test_engine_cache_yields_before_preemption():
    """The reference's eviction-order target (tests/test_prefix_cache.py:
    245-268): a pool mostly squatted by one request's cached pages serves
    an unrelated, longer prompt by EVICTING the cache, not by preempting
    anyone — with the reference's ticks and pools."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (32, 40)]
    got = check_engine("llama2-7b", prefix_cache=True, max_batch=1,
                       n_pages=8, prompts=prompts, max_new=2)
    assert got["prefix"]["cache_evicted_pages"] > 0
    assert got["preemptions"] == 0
