"""The port's model assembly against the JAX package's on the CPU, on the
reduced configs of the paper's two models (llama2-7b: MHA, G=1; qwen3-8b:
GQA G=4 with qk-norm) in f32, with the reference's own weights carried over
by ``params_from_jax``: the weight converter, the random init's layout, and
two packed prefill ticks plus a paged decode step — logits (atol 1e-4) and
the written pools (atol 1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import \
    forward_chunk_packed as jax_forward_chunk_packed
from repro.models.transformer import init_params as jax_init_params
from repro.serving.kv_pool import KVPool as JaxKVPool
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

MODELS = ["llama2-7b", "qwen3-8b"]


def _cfgs(name):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    return jcfg, cfg


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed),
                                                    jcfg))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", MODELS)
def test_params_from_jax_round_trip(name):
    jcfg, _ = _cfgs(name)
    jp = _jax_params(jcfg)
    tp = params_from_jax(jp, "cpu")
    got, want = dict(_leaves(tp)), dict(_leaves(jp))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert isinstance(got[k], torch.Tensor), k
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    bf = params_from_jax(jp, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(bf))


def test_params_from_jax_refuses_other_layouts():
    jcfg, _ = _cfgs("llama2-7b")
    jp = _jax_params(jcfg)
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in jp.items() if k != "embed"}, "cpu")
    bad = dict(jp, runs=[{k: v for k, v in jp["runs"][0].items()
                          if k != "ffn"}])
    with pytest.raises(ValueError, match="ffn"):
        params_from_jax(bad, "cpu")


@pytest.mark.parametrize("name", MODELS)
def test_init_params_layout_matches_reference(name):
    """The port's own init draws a tree of the reference's layout, shapes
    and dtype (the card has no JAX, so the smoke run draws its own)."""
    jcfg, cfg = _cfgs(name)
    want = {k: v.shape for k, v in _leaves(_jax_params(jcfg))}
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = {k: tuple(v.shape) for k, v in _leaves(tp)}
    assert got == want
    assert all(v.dtype == torch.float32 for _, v in _leaves(tp))


def test_unported_families_raise():
    with pytest.raises(NotImplementedError):
        T.build_plan(dataclasses.replace(get_config("qwen3-8b").reduced(),
                                         family="hybrid"))


def _max_pool_err(jcaches, tcaches):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for jc, tc in zip(jcaches, tcaches)
               for a, b in zip((jc["k"], jc["v"]), (tc["k"], tc["v"])))


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_reference(name):
    """Two packed prefill ticks (two segments, then one resuming with
    history, 8-aligned starts, pad segments) and one paged decode step,
    through the same pool tables on both sides."""
    jcfg, cfg = _cfgs(name)
    jp = _jax_params(jcfg)
    tp = params_from_jax(jp, "cpu")
    pool = JaxKVPool(jcfg, n_slots=4, page_size=8, n_pages=32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (13, 7)]
    slots = [0, 2]
    for s, p in zip(slots, prompts):
        assert pool.grow(s, len(p))
    bts = pool.block_tables()
    jc = pool.caches
    tc = [{k: torch.zeros(tuple(v.shape)) for k, v in c.items()}
          for c in jc]
    # tick 1: request 0 tokens [0, 8), request 1 tokens [0, 7);
    # tick 2: request 0 tokens [8, 13) on top of its history
    for segs in ([(0, 0, 8), (1, 0, 7)], [(0, 8, 5)]):
        Tn, N = 24, 4
        toks = np.zeros(Tn, np.int32)
        starts = np.full(N, Tn, np.int32)
        offs = np.zeros(N, np.int32)
        lens = np.zeros(N, np.int32)
        sl = np.full(N, 4, np.int32)
        cur = 0
        for i, (ri, off, take) in enumerate(segs):
            toks[cur:cur + take] = prompts[ri][off:off + take]
            starts[i], offs[i], lens[i], sl[i] = cur, off, take, slots[ri]
            cur = -(-(cur + take) // 8) * 8
        jl, jc = jax_forward_chunk_packed(jp, jcfg, toks, starts, offs, lens,
                                          sl, jc, block_tables=bts,
                                          pack_align=8)
        tl, tc = T.forward_chunk_packed(
            tp, cfg, torch.from_numpy(toks), torch.from_numpy(starts),
            torch.from_numpy(offs), torch.from_numpy(lens),
            torch.from_numpy(sl), tc,
            block_tables=[torch.from_numpy(np.array(b)) for b in bts])
        n = len(segs)
        np.testing.assert_allclose(tl.numpy()[:n], np.asarray(jl)[:n],
                                   atol=1e-4, rtol=0)
        assert _max_pool_err(jc, tc) <= 1e-5
    # one decode step for both requests, in bucketed rows 0..1
    for s, p in zip(slots, prompts):
        assert pool.grow(s, len(p) + 1)
    bts = pool.block_tables(rows=slots, n=2)
    tok = np.array([[5], [9]], np.int32)
    pos = np.array([13, 7], np.int32)
    jl, jc, _ = jax_forward(jp, jcfg, {"tokens": jnp.asarray(tok)},
                            phase="decode", cache=jc, pos=jnp.asarray(pos),
                            block_tables=bts)
    tl, tc, _ = T.forward(
        tp, cfg, {"tokens": torch.from_numpy(tok)}, phase="decode", cache=tc,
        pos=torch.from_numpy(pos),
        block_tables=[torch.from_numpy(np.array(b)) for b in bts])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert _max_pool_err(jc, tc) <= 1e-5


def test_forward_refuses_unported_phases():
    _, cfg = _cfgs("llama2-7b")
    tp = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        T.forward(tp, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                  phase="train")
