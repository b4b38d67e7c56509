"""The host KV tier and the disaggregated executor (ROADMAP A9) of the
port's engine against the JAX package's on the CPU, on reduced llama2-7b in
f32 (``torch_tier_parity``): preemption swapped through the host tier,
recomputed, or falling back when the tier is full; prefix blocks demoted
to it and promoted back; colocated against disaggregated on the paged
pool, int8 KV and the dense arena.  Tick logs (swap bytes, host pages and
migration included), counts(), prefix stats, pools, the host tier's free
lists and streams equal the reference's after every tick.  Also: a
swapped-out request's pages come back bit for bit, and the host tier's
store is pinned only beside a pool on the card."""

import numpy as np
import pytest
import torch

from repro.serving import kv_pool as jax_kv_pool
from repro_torch.serving.kv_pool import HostTier, KVPool, _stretches
from repro_torch.serving.sampling import SamplingParams
from torch_spec_parity import models
from torch_tier_parity import (DISAGG_CASES, PREFIX_CASES, TIER_CASES,
                               build, disagg_case, prefix_case,
                               prompts_of, tier_case)

NAME = "llama2-7b"


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_swap_and_recompute_match_the_reference(case):
    tier_case(NAME, case)


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_demote_and_promote_match_the_reference(case):
    prefix_case(NAME, case)


@pytest.mark.parametrize("case", sorted(DISAGG_CASES))
def test_disaggregated_matches_colocated_and_the_reference(case):
    disagg_case(NAME, case)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "int4"])
def test_swapped_pages_come_back_bit_for_bit(kv_dtype):
    """Every leaf of every page a victim held (K/V and, quantized, the
    scale pages) read before its swap-out equals what its new pages hold
    after the swap-in, and the host tier's per-page ``store``/``load``
    agree with the batched copies."""
    eng = build(NAME, n_pages=14, host_spill_pages=64, kv_dtype=kv_dtype,
                max_batch=4)[1]
    before, after = {}, {}
    swap_out, swap_in = eng._swap_out, eng._try_swap_in

    def out(req):
        pages = [[int(q) for q in p.table[req.slot, :p.pages_of(
            eng.pool.len_of(req.slot))]] for p in eng.pool.pools]
        before[req.req_id] = [[eng._read_page(r, q) for q in qs]
                              for r, qs in enumerate(pages)]
        return swap_out(req)

    def back(req, slot):
        ok = swap_in(req, slot)
        if ok:
            after[req.req_id] = [
                [eng._read_page(r, int(q)) for q in p.table[slot, :len(
                    before[req.req_id][r])]]
                for r, p in enumerate(eng.pool.pools)]
        return ok

    eng._swap_out, eng._try_swap_in = out, back
    eng.generate(prompts_of(NAME, (30, 25, 21, 18), seed=9),
                 SamplingParams(max_new_tokens=10))
    assert after and set(after) <= set(before)
    n_leaves = 0
    for rid, runs in after.items():
        for r, pages in enumerate(runs):
            for got, want in zip(pages, before[rid][r]):
                assert set(got) == set(want) == set(eng.cache[r])
                for k in want:
                    assert torch.equal(got[k], want[k]), (rid, r, k)
                    n_leaves += 1
    assert n_leaves > 0
    # the per-page API against the batched one
    tier = eng.host_tier
    page = {k: torch.randn(v[:, 0].shape).to(v.dtype)
            for k, v in eng.cache[0].items()}
    (hp,) = tier.alloc(0, 1)
    tier.store(0, hp, page)
    loaded = tier.load_pages(0, [hp], "cpu")
    for k, v in page.items():
        assert torch.equal(tier.load(0, hp)[k], v)
        assert torch.equal(loaded[k][:, 0], v)
    tier.release(0, [hp])
    tier.check_invariants()


def test_host_tier_accounting_matches_the_reference():
    """Allocation, release and the byte counters of the host tier equal
    the reference's op by op over a random sequence; the store mirrors
    every leaf (page axis first), unpinned beside a CPU pool; one copy per
    stretch of consecutive host pages."""
    jcfg, _, cfg, _ = models(NAME)
    ours = HostTier(KVPool(cfg, 2, 10, 8, "int8", device="cpu"), 6)
    ref = jax_kv_pool.HostTier(jax_kv_pool.KVPool(jcfg, 2, 10, 8, "int8"), 6)
    assert not ours.pinned
    assert {k: tuple(v.shape) for k, v in ours._store[0].items()} == {
        k: (v.shape[1], v.shape[0]) + tuple(v.shape[2:])
        for k, v in ref._store[0].items()}
    rng = np.random.default_rng(0)
    held = []
    for _ in range(200):
        if held and rng.random() < 0.4:
            pages = held.pop(int(rng.integers(len(held))))
            ours.release(0, pages)
            ref.release(0, pages)
        else:
            n = int(rng.integers(1, 4))
            a, b = ours.alloc(0, n), ref.alloc(0, n)
            assert a == b
            if a is not None:
                held.append(a)
                ours.store_pages(0, a, {k: torch.zeros(
                    (v.shape[1], n) + tuple(v.shape[2:]), dtype=v.dtype)
                    for k, v in ours._store[0].items()})
                for q in a:
                    ref.store(0, q, {k: v[:, q] for k, v in
                                     ref._store[0].items()})
        assert ours.free == ref.free
        assert ours.stats() == ref.stats()
        ours.check_invariants()
    assert _stretches([3, 4, 5, 9, 2, 3]) == [(0, 3, 3), (3, 9, 1),
                                              (4, 2, 2)]
