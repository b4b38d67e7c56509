"""The port's whole-model dense-arena passes against the JAX package's on
the CPU, reduced llama2-7b and qwen3-8b in f32 with the reference's own
weights: the whole-prompt forward and its splice into an arena slot, a
dense decode step after it, and packed chunks into the arena.  Tolerances
as in ``test_torch_dense_model.py`` (logits atol 1e-4; K/V and arena
``_kv_atol``, 1e-5 plus the RoPE term), whose helpers these are; arena
rows the reference leaves alone must be left bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.models import transformer as T
from test_torch_dense_model import (MODELS, _arena, _close, _kv_atol,
                                    _setup, _torch_tree)


@pytest.mark.parametrize("T_len", [40, 3072])
@pytest.mark.parametrize("name", MODELS)
def test_prefill_splice_and_decode_match_reference(name, T_len):
    """forward(phase="prefill") (last-position logits and the ring-order
    cache), prefill_into_arena into slot 2 of an arena of stale values
    (the other slots and the positions past the prompt untouched), and
    one dense decode step after it.  3072 tokens pass the 2048-token
    dense threshold."""
    jcfg, cfg, jp, tp = _setup(name)
    toks = np.random.default_rng(T_len).integers(
        0, cfg.vocab_size, (1, T_len)).astype(np.int32)
    wl, wcache, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                               phase="prefill")
    gl, gcache, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                              phase="prefill")
    assert gl.shape == (1, 1, T.padded_vocab(cfg))
    _close(gl, wl, 1e-4)
    for g, w in zip(gcache, wcache):
        assert g.keys() == w.keys()
        for key in g:
            _close(g[key], w[key], _kv_atol(T_len, w[key]))

    B, S = 3, T_len + 8
    arena = _arena(jcfg, B, S, seed=T_len)
    wl, warena = JT.prefill_into_arena(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, jnp.int32(2),
        jax.tree.map(jnp.asarray, arena))
    tarena = _torch_tree(arena)
    gl, garena = T.prefill_into_arena(
        tp, cfg, {"tokens": torch.from_numpy(toks)}, 2, tarena)
    assert garena is tarena
    _close(gl, wl, 1e-4)
    for g, w, old in zip(garena, warena, arena):
        for key in g:
            _close(g[key], w[key], _kv_atol(T_len, w[key]))
            assert torch.equal(g[key][:, :2],
                               torch.from_numpy(old[key][:, :2]))
            assert torch.equal(g[key][:, 2, T_len:],
                               torch.from_numpy(old[key][:, 2, T_len:]))

    # one decode step: slot 2 at its prompt's end, slots 0 and 1 elsewhere
    pos = np.array([S - 1, 3, T_len], np.int32)
    dtok = np.array([[1], [2], [3]], np.int32)
    wl, warena, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(dtok)},
                               phase="decode", cache=warena,
                               pos=jnp.asarray(pos))
    gl, garena, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(dtok)},
                              phase="decode", cache=garena,
                              pos=torch.from_numpy(pos))
    _close(gl, wl, 1e-4)
    for g, w in zip(garena, warena):
        for key in g:
            _close(g[key], w[key], _kv_atol(S, w[key]))


@pytest.mark.parametrize("name", MODELS)
def test_packed_chunks_into_the_arena_match_reference(name):
    """Two packed ticks into a 3-slot, 64-position arena of stale values:
    the first carries the first chunks of two prompts (slots 0 and 2) and
    a pad segment, the second their continuations (history read from the
    arena).  Logits of each segment's last token and the arena agree; slot
    1 is never written."""
    jcfg, cfg, jp, tp = _setup(name)
    arena = _arena(jcfg, 3, 64, seed=4)
    rng = np.random.default_rng(4)
    ticks = [  # (lengths, offsets, slots) of two real segments + one pad
        ((21, 9), (0, 0), (0, 2)),
        ((13, 30), (21, 9), (0, 2)),
    ]
    warena = jax.tree.map(jnp.asarray, arena)
    garena = _torch_tree(arena)
    for lens, offs, slots in ticks:
        starts, cur = [], 0
        for n in lens:
            starts.append(cur)
            cur = -(-(cur + n) // 8) * 8
        Tn = cur
        toks = np.zeros((Tn,), np.int32)
        for s, n in zip(starts, lens):
            toks[s:s + n] = rng.integers(0, cfg.vocab_size, n)
        meta = [np.array(list(a) + [b], np.int32) for a, b in
                ((starts, Tn), (offs, 0), (lens, 0), (slots, 3))]
        wl, warena = JT.forward_chunk_packed(
            jp, jcfg, jnp.asarray(toks), *map(jnp.asarray, meta), warena,
            pack_align=8)
        gl, garena = T.forward_chunk_packed(
            tp, cfg, torch.from_numpy(toks), *map(torch.from_numpy, meta),
            garena, pack_align=8)
        _close(gl[:2], np.asarray(wl)[:2], 1e-4)
    for g, w, old in zip(garena, warena, arena):
        for key in g:
            _close(g[key], w[key], 1e-5)
            assert torch.equal(g[key][:, 1], torch.from_numpy(old[key][:, 1]))
