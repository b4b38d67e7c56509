"""The port's Zamba2 hybrid (zamba2-2.7b) against the JAX package's on the
CPU, in f32 with the reference's own weights of the reduced config
(``params_from_jax``): the run plan, the random init's layout, the
converter, a whole-prompt prefill's logits and every cache leaf, three
decode steps over the arena with a ``slot_mask``, ``splice_arena``,
``prefill_into_arena``, ``pad_cache``, ``cache_specs``, ``prefill`` and
``decode_step``.  The reduced config is 4 Mamba-2 layers at d_model 64 in
runs of 2, each followed by the shared block (4 heads of 32 over
concat([h, embed0]), 128 wide).  Inputs are drawn with numpy from a seed.

Tolerance: atol 1e-4 (rtol 1e-5) for logits and cache leaves — several
layers of f32 matmuls, scans and softmaxes in another order on each side;
the largest difference seen on a CPU is ~4e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serving.quantized_weights import quantize_params as jax_quantize
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

NAME = "zamba2-2.7b"
TOL = dict(rtol=1e-5, atol=1e-4)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(NAME).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(NAME).reduced(), dtype=dtype)
    return jcfg, cfg


def _setup():
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _tokens(seed, shape, cfg):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _assert_caches(got, want, rows=None):
    """Every leaf of every run equal within TOL (at batch ``rows`` only
    when given: batch axis 0 for a shared run, 1 for an SSM run)."""
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            a, b = g[key].numpy(), np.asarray(w[key])
            assert a.shape == b.shape, key
            if rows is not None:
                ax = 1 if key in ("conv", "state") else 0
                a, b = np.take(a, rows, axis=ax), np.take(b, rows, axis=ax)
            np.testing.assert_allclose(a, b, err_msg=key, **TOL)


def test_plan_matches_reference():
    """9 x [6 ssd | shared_attn] at full width, 2 x [2 ssd | shared_attn]
    reduced, run for run; the reference's own structure test's kinds."""
    jcfg, cfg = _cfgs()
    for ours, ref in ((get_config(NAME), jax_get_config(NAME)),
                      (cfg, jcfg)):
        plan = T.build_plan(ours)
        assert [dataclasses.asdict(r) for r in plan] == [
            dataclasses.asdict(r) for r in JT.build_plan(ref)]
        kinds = [r.kind for r in plan]
        assert "shared_attn" in kinds and "ssm" in kinds
    full = T.build_plan(get_config(NAME))
    assert [(r.kind, r.n_layers) for r in full] == [
        ("ssm", 6), ("shared_attn", 0)] * 9
    assert [(r.kind, r.n_layers) for r in T.build_plan(cfg)] == [
        ("ssm", 2), ("shared_attn", 0)] * 2
    assert not T.supports_paged(cfg) and not T.supports_chunked_prefill(cfg)


@pytest.mark.parametrize("family", ["ssm", "dense"])
def test_family_mismatch_raises(family):
    """A hybrid config served as another family (and the other way round,
    ``test_torch_ssm.py::test_other_families_still_raise``) is refused
    with the item that would bring it."""
    cfg = dataclasses.replace(get_config(NAME).reduced(), family=family)
    with pytest.raises(NotImplementedError, match="item 11"):
        T.build_plan(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_reference(dtype):
    """The port's own init draws the reference's tree: one ``shared_attn``
    block (attention 128 -> 4 x 32 -> 128, FFN 128 -> 128 -> 128, ``down``
    [128, 64]), each shared run's ``runs[r]`` empty; every shape and
    dtype equal (A_log, D and dt_bias in f32)."""
    jcfg, cfg = _cfgs(dtype)
    want = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    ours = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ours["runs"][1] == {} and ours["runs"][3] == {}
    assert tuple(ours["shared_attn"]["down"].shape) == (128, 64)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in _leaves(ours)} == {
        k: (v.shape, v.dtype.name) for k, v in _leaves(want)}


def test_converter_carries_the_reference_weights():
    """Every leaf (the shared block's included) copied exactly; a missing
    shared leaf, or no ``shared_attn`` beside empty runs, raises."""
    _, _, jp, tp = _setup()
    want = dict(_leaves(jp))
    got = dict(_leaves(tp))
    assert got.keys() == want.keys()
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    attn = {k: v for k, v in jp["shared_attn"]["attn"].items() if k != "wq"}
    with pytest.raises(ValueError, match="shared_attn"):
        params_from_jax(dict(jp, shared_attn=dict(jp["shared_attn"],
                                                  attn=attn)), "cpu")
    with pytest.raises(ValueError, match="shared_attn"):
        params_from_jax({k: v for k, v in jp.items() if k != "shared_attn"},
                        "cpu")
    no_down = {k: v for k, v in jp["shared_attn"].items() if k != "down"}
    with pytest.raises(ValueError, match="down"):
        params_from_jax(dict(jp, shared_attn=no_down), "cpu")


def test_converter_keeps_quantized_shared_leaves():
    """Under int8 weights the reference quantizes ``down`` and the shared
    projections to {"q", "scale"}; the converter keeps int8 values and f32
    scales, exactly."""
    jcfg, _, _, _ = _setup()
    jq = jax.tree.map(np.asarray, jax_quantize(
        JT.init_params(jax.random.PRNGKey(0), jcfg), min_size=0))
    tq = params_from_jax(jq, "cpu")
    sa = tq["shared_attn"]
    for leaf in (sa["down"], sa["attn"]["wq"], sa["attn"]["wo"],
                 sa["ffn"]["wi_gate"]):
        assert set(leaf) == {"q", "scale"}
        assert leaf["q"].dtype == torch.int8
        assert leaf["scale"].dtype == torch.float32
    np.testing.assert_array_equal(sa["down"]["q"].numpy(),
                                  jq["shared_attn"]["down"]["q"])
    np.testing.assert_array_equal(sa["down"]["scale"].numpy(),
                                  jq["shared_attn"]["down"]["scale"])


@pytest.mark.parametrize("T_len", [2, 24, 64, 96])
def test_prefill_matches_reference(T_len):
    """A whole-prompt prefill at batch 2: the last position's logits and
    every cache leaf — SSM conv windows and states, each shared run's K/V
    [B, T, 4, 32] — over one (2, 24), two (64) and three (96) SSD
    chunks."""
    jcfg, cfg, jp, tp = _setup()
    toks = _tokens(T_len, (2, T_len), cfg)
    wl, wc, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           phase="prefill")
    gl, gc, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                          phase="prefill")
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    _assert_caches(gc, wc)
    assert tuple(gc[1]["k"].shape) == (2, T_len, 4, 32)


def test_decode_steps_with_slot_mask_match_reference():
    """Three decode steps over an arena of 3 slots (a 24-token prefill,
    padded to 40 positions): the reference decodes every row, the port
    with ``slot_mask`` [True, False, True] — rows 0 and 2 take the
    reference's logits and cache, row 1 keeps its arena rows bit for
    bit."""
    jcfg, cfg, jp, tp = _setup()
    toks = _tokens(5, (3, 24), cfg)
    wl, wc, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           phase="prefill")
    gl, gc, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                          phase="prefill")
    wc, gc = JT.pad_cache(jcfg, wc, 24, 40), T.pad_cache(cfg, gc, 24, 40)
    idle = [{k: v[1].clone() if k in ("k", "v") else v[:, 1].clone()
             for k, v in c.items()} for c in gc]
    mask = torch.tensor([True, False, True])
    live = [0, 2]
    for step in range(3):
        nxt = np.asarray(wl).argmax(-1).astype(np.int32)           # [3, 1]
        wl, wc, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(nxt)},
                               phase="decode", cache=wc, pos=24 + step)
        gl, gc, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(nxt)},
                              phase="decode", cache=gc, pos=24 + step,
                              slot_mask=mask)
        np.testing.assert_allclose(gl.numpy()[live], np.asarray(wl)[live],
                                   **TOL)
        _assert_caches(gc, wc, rows=live)
    for c, old in zip(gc, idle):
        for k, v in c.items():
            now = v[1] if k in ("k", "v") else v[:, 1]
            assert torch.equal(now, old[k]), k


def test_splice_and_prefill_into_arena_match_reference():
    """A one-request prefill (64 tokens) into slot 1 of a 2-slot arena of
    96 positions: the port's ``splice_arena`` of its prefill cache and its
    ``prefill_into_arena`` (each layer's leaves written as made) both give
    the reference's ``splice_arena`` arena, slot 0 left zero; the last
    logits equal too."""
    jcfg, cfg, jp, tp = _setup()
    toks = _tokens(7, (1, 64), cfg)
    wl, piece, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              phase="prefill")
    want = JT.splice_arena(jcfg, JT.init_cache(jcfg, 2, 96), piece, 1)
    gl, gpiece, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                              phase="prefill")
    spliced = T.splice_arena(cfg, T.init_cache(cfg, 2, 96, "cpu"), gpiece, 1)
    _assert_caches(spliced, want)
    il, direct = T.prefill_into_arena(tp, cfg,
                                      {"tokens": torch.from_numpy(toks)}, 1,
                                      T.init_cache(cfg, 2, 96, "cpu"))
    _assert_caches(direct, want)
    for c in direct:
        for k, v in c.items():
            assert not (v[0] if k in ("k", "v") else v[:, 0]).any(), k
    np.testing.assert_allclose(il.numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)


def test_pad_cache_and_cache_specs_match_reference():
    """``pad_cache`` grows a shared leaf on axis 1 and keeps SSM state;
    ``cache_specs`` gives ``init_cache``'s shapes and dtypes without
    allocating (the ``meta`` device), as the reference's ``eval_shape``
    does, in f32 and bf16."""
    jcfg, cfg, jp, tp = _setup()
    toks = _tokens(9, (2, 32), cfg)
    _, wc, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          phase="prefill")
    _, gc, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                         phase="prefill")
    wp, gp = JT.pad_cache(jcfg, wc, 32, 48), T.pad_cache(cfg, gc, 32, 48)
    _assert_caches(gp, wp)
    assert tuple(gp[1]["v"].shape) == (2, 48, 4, 32)
    assert gp[0]["state"] is gc[0]["state"]
    assert not gp[1]["k"][:, 32:].any()
    for dtype in ("float32", "bfloat16"):
        jc, c = _cfgs(dtype)
        want = JT.cache_specs(jc, 3, 40)
        got = T.cache_specs(c, 3, 40)
        for w, g in zip(want, got):
            assert set(w) == set(g)
            for key in w:
                assert g[key].device.type == "meta"
                assert tuple(g[key].shape) == w[key].shape
                assert str(g[key].dtype).split(".")[1] == w[key].dtype.name


def test_prefill_and_decode_step_helpers_match_reference():
    """The module's ``prefill`` and ``decode_step`` (what
    ``examples/quickstart.py`` calls): a 32-token prefill padded to 40
    positions, then two decode steps."""
    jcfg, cfg, jp, tp = _setup()
    toks = _tokens(11, (2, 32), cfg)
    wl, wc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    gl, gc = T.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    wc, gc = JT.pad_cache(jcfg, wc, 32, 40), T.pad_cache(cfg, gc, 32, 40)
    for step in range(2):
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        nxt = np.asarray(wl).argmax(-1).astype(np.int32)
        wl, wc = JT.decode_step(jp, jcfg, {"tokens": jnp.asarray(nxt)}, wc,
                                32 + step)
        gl, gc = T.decode_step(tp, cfg, {"tokens": torch.from_numpy(nxt)},
                               gc, 32 + step)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    _assert_caches(gc, wc)
