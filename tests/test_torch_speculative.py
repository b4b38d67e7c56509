"""The port's speculative-decoding pieces (ROADMAP A7b) against the JAX
package's on the CPU: the padded chunk forward over the paged pool
(``forward_chunk`` with block tables and ``attn_chunk_paged``, float,
int8 and int4 pools, a sliding-window ring and softcap), greedy
``verify_draft``, the n-gram drafter's proposals, and the options this
slice still refuses.  Tolerance for the f32 forward: |err| <= 1e-5 on
logits and pool values (both sides compute the reference's masked
attention in f32; the observed gap is below 1e-6), integer pages equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models.transformer import forward_chunk as jax_forward_chunk
from repro.serving.kv_pool import KVPool as JaxKVPool
from repro.serving.sampling import verify_draft as jax_verify_draft
from repro.serving.speculative import NGramDrafter as JaxNGramDrafter
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch.models import attention
from repro_torch.models.transformer import forward_chunk
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.sampling import verify_draft
from repro_torch.serving.speculative import (NGramDrafter, SpecConfig,
                                             build_drafter)

from torch_spec_parity import models

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_pool(jcache, tcache):
    for key in jcache:
        a, b = np.asarray(jcache[key]), _np(tcache[key])
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, err_msg=key, **TOL)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "int4"])
@pytest.mark.parametrize("name", ["llama2-7b", "qwen3-8b"])
def test_forward_chunk_matches_reference(name, kv_dtype):
    """Two padded chunk batches through both models over their pools: a
    first one building history (last-position logits; a pad row), then a
    window over that history with every position's logits, the port given
    block tables narrowed to the positions the call reaches."""
    jcfg, jp, cfg, tp = models(name)
    jpool = JaxKVPool(jcfg, n_slots=3, n_pages=16, page_size=8,
                      kv_dtype=kv_dtype)
    tpool = KVPool(cfg, n_slots=3, n_pages=16, page_size=8,
                   kv_dtype=kv_dtype, device="cpu")
    rng = np.random.default_rng(1)
    jcache = jpool.caches
    calls = [(rng.integers(0, cfg.vocab_size, (3, 20)), [0, 0, 0],
              [11, 20, 0], [0, 1, 3], False),
             (rng.integers(0, cfg.vocab_size, (3, 5)), [11, 20, 0],
              [5, 3, 4], [0, 1, 2], True)]
    for toks, offs, lens, slots, every in calls:
        for pool in (jpool, tpool):
            for s, (o, n) in enumerate(zip(offs, lens)):
                if slots[s] < 3:
                    pool.grow(slots[s], max(o + n, pool.len_of(slots[s])))
        toks = toks.astype(np.int32)
        arrs = [np.asarray(a, np.int32) for a in (offs, lens, slots)]
        want, jcache = jax_forward_chunk(
            jp, jcfg, jnp.asarray(toks), *map(jnp.asarray, arrs), jcache,
            block_tables=jpool.block_tables(), return_all_logits=every)
        got, _ = forward_chunk(
            tp, cfg, torch.from_numpy(toks), *map(torch.from_numpy, arrs),
            tpool.caches,
            block_tables=tpool.block_tables(
                upto=int((arrs[0] + arrs[1]).max())),
            return_all_logits=every)
        want, got = np.asarray(want), got.numpy()
        for n, ln in enumerate(lens):
            if slots[n] < 3 and ln:
                rows = slice(0, ln) if every else slice(0, 1)
                np.testing.assert_allclose(got[n, rows], want[n, rows],
                                           **TOL)
        for r in range(len(jcache)):
            _same_pool(jcache[r], tpool.caches[r])


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_attn_chunk_paged_ring_matches_reference(softcap):
    """One layer over a sliding-window pool whose ring (12 positions) one
    row's history has wrapped: the history read before the chunk's own
    writes, the window mask, and only each row's last ring positions
    written."""
    jcfg, jp, cfg, tp = models("qwen3-8b")                 # qk_norm
    jlayer = jax.tree.map(lambda a: a[0], jp["runs"][0]["attn"])
    tlayer = {k: v[0] for k, v in tp["runs"][0]["attn"].items()}
    rng = np.random.default_rng(2)
    n_pages, P, Hkv, D = 8, 4, cfg.n_kv_heads, cfg.d_head
    k0 = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    v0 = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    bt = np.array([[2, 5, 7], [0, 1, 8], [3, 4, 6]], np.int32)
    offs = np.array([20, 3, 0], np.int32)
    lens = np.array([5, 4, 0], np.int32)
    slots = np.array([0, 1, 3], np.int32)
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=Hkv, d_head=D,
              theta=cfg.attn.rope_theta, window=12, softcap=softcap,
              qk_norm=True)
    want, wcache = jax_attn.attn_chunk_paged(
        jlayer, jnp.asarray(x), jnp.asarray(offs), jnp.asarray(lens),
        jnp.asarray(slots), {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(bt), **kw)
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy())}
    got, _ = attention.attn_chunk_paged(
        tlayer, torch.from_numpy(x), torch.from_numpy(offs),
        torch.from_numpy(lens), torch.from_numpy(slots), tcache,
        torch.from_numpy(bt), **kw)
    for n in range(2):
        np.testing.assert_allclose(got.numpy()[n, :lens[n]],
                                   np.asarray(want)[n, :lens[n]], **TOL)
    _same_pool(wcache, tcache)


def test_verify_draft_matches_reference():
    """Greedy acceptance over windows with tied logits (argmax takes the
    first maximum on both sides), every draft length 0..4 and drafts that
    agree for a while and then do not: the same candidate tokens and
    emission counts.  Stochastic verification without a key raises, as
    the reference's does."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        logits = rng.integers(0, 4, (6, 5, 9)).astype(np.float32)
        tgt = logits.argmax(-1)
        draft = tgt[:, :4].copy()
        flip = rng.random((6, 4)) < 0.3
        draft[flip] = rng.integers(0, 9, int(flip.sum()))
        draft_len = rng.integers(0, 5, 6).astype(np.int32)
        want = jax_verify_draft(jnp.asarray(logits), jnp.asarray(draft),
                                jnp.asarray(draft_len), greedy=True)
        got = verify_draft(torch.from_numpy(logits),
                           torch.from_numpy(draft.astype(np.int32)),
                           torch.from_numpy(draft_len))
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # stochastic verification needs its randomness source, as the
    # reference's needs its PRNG key
    with pytest.raises(ValueError, match="requires a"):
        verify_draft(torch.zeros(1, 2, 3), torch.zeros(1, 1),
                     torch.ones(1), greedy=False)


@pytest.mark.parametrize("spec", [dict(), dict(ngram_max=1),
                                  dict(ngram_max=4, ngram_min=2,
                                       ngram_search=24)])
def test_ngram_drafter_matches_reference(spec):
    """Prompt lookup over streams with loops, for k = 1..5: the same
    proposals (most recent occurrence of the longest recurring suffix) or
    none, batch by batch."""
    rng = np.random.default_rng(4)
    ours = NGramDrafter(SpecConfig(**spec))
    ref = JaxNGramDrafter(JaxSpecConfig(**spec))
    for trial in range(40):
        loop = rng.integers(0, 12, int(rng.integers(2, 7)))
        ctx = np.concatenate([rng.integers(0, 12, int(rng.integers(0, 20))),
                              np.tile(loop, int(rng.integers(1, 5))),
                              rng.integers(0, 12, int(rng.integers(0, 3)))
                              ]).astype(np.int32)
        items = [(0, trial, ctx), (2, trial, ctx[: len(ctx) // 2 + 1])]
        k = 1 + trial % 5
        got, want = ours.propose_batch(items, k), ref.propose_batch(items, k)
        assert got.keys() == want.keys()
        for slot in got:
            np.testing.assert_array_equal(got[slot], want[slot])
    assert ours.proposed == ref.proposed > 0


def test_model_drafter_is_item_7c():
    """The reference's small-model drafter waits for qwen3-1.7b (ROADMAP
    A11c): the engine and the factory refuse it, naming item 7c."""
    spec = SpecConfig(k=2, drafter="model", draft_arch="llama2-7b")
    with pytest.raises(NotImplementedError, match="item 7c"):
        build_drafter(spec)
    _, _, cfg, tp = models("llama2-7b")
    with pytest.raises(NotImplementedError, match="item 7c"):
        ServingEngine(cfg, tp, ServeConfig(paged=True, speculative=spec),
                      device="cpu")


def test_dense_forward_chunk_is_item_11():
    """``forward_chunk`` without block tables (the dense arena's padded
    batch) stays unported."""
    _, _, cfg, tp = models("llama2-7b")
    with pytest.raises(NotImplementedError, match="item 11"):
        forward_chunk(tp, cfg, torch.zeros(1, 2, dtype=torch.long),
                      torch.zeros(1), torch.ones(1), torch.zeros(1), [])
