"""The port's dense-arena model paths against the JAX package's on the CPU,
on the reduced llama2-7b (MHA) and qwen3-8b (GQA, qk-norm) in f32 with the
reference's own weights (``params_from_jax``): whole-prompt attention on
both sides of the dense threshold, one-token decode against the arena with
per-row positions (a wrapped ring among them), and the ring order of a
prefill's K/V.  ``test_torch_dense_forward.py`` holds the whole-model
passes, with these helpers.

Tolerances: logits and attention outputs atol 1e-4, K/V and arena
contents atol 1e-5 — f32 on both sides, differing in the order of sums
(blockwise or flash versus dense, einsum versus matmul) — plus, for K/V
made at positions up to p, the RoPE term of ``_kv_atol``.  Arena rows the
reference leaves alone must be left bit-identical."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

MODELS = ["llama2-7b", "qwen3-8b"]


def _setup(name):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    jp = jax.tree.map(np.asarray,
                      JT.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


def _kw(cfg, window=0):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                d_head=cfg.d_head, theta=cfg.attn.rope_theta, window=window,
                qk_norm=cfg.attn.qk_norm)


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["runs"][0]["attn"]),
            T.layer_view(tp["runs"][0]["attn"], 0))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _kv_atol(T_len, want):
    """K/V tolerance for positions below T_len: an f32 RoPE angle p * theta
    is good only to half an ulp of p, 2^(floor(log2 p) - 24) rad, and the
    two frameworks round it apart; a key moves by at most that times its
    magnitude (past position 2048: 1.2e-4 |k|), and a later layer's K/V
    inherit it through the attention output."""
    rope = 2.0 ** (math.floor(math.log2(T_len - 1)) - 24)
    return 1e-5 + rope * float(np.abs(np.asarray(want)).max())


def _arena(jcfg, B, S, seed):
    """A dense arena [L, B, S, Hkv, D] per run full of stale values (as a
    served arena holds), as numpy."""
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(np.shape(v)).astype(np.float32)
             for k, v in c.items()} for c in JT.init_cache(jcfg, B, S)]


def _torch_tree(tree):
    return [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
            for c in tree]


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("T_len", [300, 1024])
@pytest.mark.parametrize("name", MODELS)
def test_attn_prefill_both_sides_of_the_threshold(name, T_len, window):
    """dense_threshold 512: 300 tokens take the dense path on both sides;
    1024 take the reference's blockwise path and the port's flash path."""
    jcfg, cfg, jp, tp = _setup(name)
    jl, tl = _layer0(jp, tp)
    x = np.random.default_rng(T_len).standard_normal(
        (1, T_len, cfg.d_model)).astype(np.float32)
    pos = np.arange(T_len, dtype=np.int32)[None]
    want, (wk, wv) = jattn.attn_prefill(
        jl, jnp.asarray(x), jnp.asarray(pos), dense_threshold=512,
        **dict(_kw(cfg), window=jnp.int32(window)))
    got, (gk, gv) = attn.attn_prefill(
        tl, torch.from_numpy(x), torch.from_numpy(pos).long(),
        dense_threshold=512, **_kw(cfg, window))
    _close(got, want, 1e-4)
    _close(gk, wk, 1e-5)
    _close(gv, wv, 1e-5)


def test_attn_prefill_refuses_the_blockwise_cases():
    jcfg, cfg, jp, tp = _setup("llama2-7b")
    _, tl = _layer0(jp, tp)
    x = torch.zeros((1, 40, cfg.d_model))
    pos = torch.arange(40)[None]
    for extra in (dict(softcap=30.0), dict(pad_mask=torch.ones(1, 40,
                                                               dtype=bool))):
        with pytest.raises(NotImplementedError, match="item 11"):
            attn.attn_prefill(tl, x, pos, dense_threshold=16, **extra,
                              **_kw(cfg))


@pytest.mark.parametrize("name", MODELS)
def test_attn_decode_vector_pos_with_a_wrapped_slot(name):
    """pos [5, 31, 40, 0] over a 32-entry ring: row 2 has wrapped (its
    new entry overwrites index 8 and all 32 entries are valid), row 3 sees
    only its new entry.  Written in place; then the same step writing
    rows 0 and 2 only leaves rows 1 and 3 bit-identical."""
    jcfg, cfg, jp, tp = _setup(name)
    jl, tl = _layer0(jp, tp)
    B, S = 4, 32
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, S, cfg.n_kv_heads, cfg.d_head)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = np.array([5, 31, 40, 0], np.int32)
    want, wk, wv = jattn.attn_decode(
        jl, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), **dict(_kw(cfg), window=jnp.int32(0)))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = attn.attn_decode(tl, torch.from_numpy(x), tk, tv,
                                   torch.from_numpy(pos), **_kw(cfg))
    assert gk is tk and gv is tv                      # updated in place
    _close(got, want, 1e-4)
    _close(gk, wk, 1e-5)
    _close(gv, wv, 1e-5)
    # only the written rows change
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    p = torch.from_numpy(pos).long()
    rows = torch.tensor([0, 2])
    got, _, _ = attn.attn_decode(tl, torch.from_numpy(x), tk, tv, p,
                                 write=attn.arena_write_index(p, S, rows),
                                 **_kw(cfg))
    _close(got[rows], np.asarray(want)[[0, 2]], 1e-4)
    _close(tk[rows], np.asarray(wk)[[0, 2]], 1e-5)
    assert torch.equal(tk[[1, 3]], torch.from_numpy(ck[[1, 3]]))
    assert torch.equal(tv[[1, 3]], torch.from_numpy(cv[[1, 3]]))


@pytest.mark.parametrize("T_len", [10, 16, 37, 40])
def test_ring_order_matches_pack_prefill_cache(T_len):
    """A windowed run's prefill K/V in decode-ring order (ring of 16):
    trimmed to the last 16 positions and rolled so index s holds the
    position p with p % 16 == s, as the reference packs them."""
    jcfg, cfg, _, _ = _setup("llama2-7b")
    k = np.random.default_rng(T_len).standard_normal(
        (2, 1, T_len, 3, 4)).astype(np.float32)
    v = -k
    jrun = JT.RunSpec("attn", 2, window=16)
    want = JT._pack_prefill_cache(jcfg, jrun, (jnp.asarray(k),
                                               jnp.asarray(v)), T_len)
    run = T.RunSpec("attn", 2, window=16)
    got = T._pack_prefill_cache(
        run, [(torch.from_numpy(k[i]), torch.from_numpy(v[i]))
              for i in range(2)], T_len)
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
