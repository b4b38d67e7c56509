"""The port's Mamba-2 block against the JAX package's on the CPU, in f32:
the plain version of the SSD chunk kernel (B7) against the Pallas
``ssd_chunk`` run in interpret mode, ``ssd_chunked``, ``ssm_prefill`` and
``ssm_decode`` on the reference's own weights of the reduced mamba2-2.7b
(``params_from_jax``), the whole model's prefill and decode, the
converter and the random init's layout.  Inputs are drawn with numpy from
a seed; dt and A are made as ``ssm_prefill`` makes them (softplus, and
-exp of A_log).

Tolerances: rtol 1e-5 plus atol 1e-4 for the SSD outputs and states: f32
on both sides, the sums in another order (a matmul against a masked
[Q, Q] product versus an einsum, a cumulative sum per chunk); each output
is a sum of up to Q + N terms (48 here) whose magnitudes add up to ~50,
whose worst-case f32 error, n 2^-24 sum|terms|, is ~1.4e-4 a side (the
largest difference seen on a CPU is 2.6e-5); atol 1e-4 for logits and
block outputs (several layers of f32 matmuls in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax

NAME = "mamba2-2.7b"
SSD_TOL = dict(rtol=1e-5, atol=1e-4)


def _setup():
    jcfg = dataclasses.replace(jax_get_config(NAME).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(NAME).reduced(), dtype="float32")
    jp = jax.tree.map(np.asarray,
                      JT.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jp, params_from_jax(jp, "cpu")


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _chunk_inputs(seed, nc, H, Q, P, N):
    """x, dt, A, B, C of the kernel's stacked signature, dt and A as
    ``ssm_prefill`` makes them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nc, H, Q, P)).astype(np.float32)
    dt_bias = np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                                 H)))).astype(np.float32)
    dt = _softplus(rng.standard_normal((nc, H, Q)) + dt_bias[None, :, None])
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    B = rng.standard_normal((nc, Q, N)).astype(np.float32)
    C = rng.standard_normal((nc, Q, N)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("nc,H,Q,P,N,bh", [
    (2, 4, 64, 32, 16, 2),       # the reference's kernel-test shapes
    (1, 8, 128, 64, 32, 2),
    (3, 4, 24, 16, 16, 4),       # Q = 24: a 24-token prompt's one chunk
    (2, 6, 40, 16, 16, 3),       # H not a multiple of the port's 4
])
def test_ssd_chunk_plain_matches_pallas(nc, H, Q, P, N, bh):
    args = _chunk_inputs(nc * 1000 + Q, nc, H, Q, P, N)
    want_y, want_st = jops.ssd_chunk(*map(jnp.asarray, args), bh=bh,
                                     interpret=True)
    got_y, got_st = ref.ssd_chunk_ref(*map(torch.from_numpy, args))
    assert got_y.dtype == got_st.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st),
                               **SSD_TOL)


def test_ssd_chunk_plain_casts_bf16_inputs_up():
    """bf16 x/B/C widen exactly: the result equals the f32 run on the
    widened values, in f32."""
    x, dt, A, B, C = map(torch.from_numpy, _chunk_inputs(7, 2, 4, 32, 16,
                                                         16))
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, B, C))
    got = ops.ssd_chunk(xb, dt, A, Bb, Cb)
    want = ref.ssd_chunk_ref(xb.float(), dt, A, Bb.float(), Cb.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_ssd_chunk_wrapper_refuses_cpu_tensors():
    args = map(torch.from_numpy, _chunk_inputs(0, 1, 4, 16, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_chunk(*args)
    assert ssd_scan.ssd_chunk.launches == 0


def test_segsum_matches_reference():
    dA = -np.abs(np.random.default_rng(1).standard_normal((2, 3, 24))
                 ).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(dA)))
    got = ssm._segsum(torch.from_numpy(dA)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T_len,chunk,with_state", [
    (64, 32, False), (96, 32, True), (24, 24, True), (2, 2, False)])
def test_ssd_chunked_matches_reference(T_len, chunk, with_state):
    rng = np.random.default_rng(T_len)
    Bsz, H, P, G, N = 2, 8, 16, 1, 16
    x = rng.standard_normal((Bsz, T_len, H, P)).astype(np.float32)
    dt = _softplus(rng.standard_normal((Bsz, T_len, H)) - 2.0)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((Bsz, T_len, G, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, T_len, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    init = (rng.standard_normal((Bsz, H, P, N)).astype(np.float32)
            if with_state else None)
    args = (x, dt, A, Bm, Cm, D)
    wy, ws = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                              None if init is None else jnp.asarray(init))
    gy, gs = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk,
                             None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **SSD_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **SSD_TOL)


def test_ssd_chunked_refuses_a_ragged_prompt():
    """The reference asserts T % chunk == 0; the port raises there."""
    x = torch.zeros((1, 40, 8, 16))
    B = torch.zeros((1, 40, 1, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(x, torch.zeros((1, 40, 8)), -torch.ones(8), B, B,
                        torch.ones(8), 32)


@pytest.mark.parametrize("T_len", [2, 24, 64, 96])
def test_ssm_prefill_matches_reference(T_len):
    """The block's output and (conv, state) — a 2-token prompt's conv
    window left-padded with zeros, 64- and 96-token ones over two and three
    chunks."""
    jcfg, cfg, jp, tp = _setup()
    h = np.random.default_rng(T_len).standard_normal(
        (2, T_len, cfg.d_model)).astype(np.float32)
    lj = jax.tree.map(lambda a: a[0], jp["runs"][0]["ssm"])
    lt = T.layer_view(tp["runs"][0]["ssm"], 0)
    wo, (wc, ws) = jssm.ssm_prefill(lj, jnp.asarray(h), cfg.d_model,
                                    jcfg.ssm)
    go, (gc, gs) = ssm.ssm_prefill(lt, torch.from_numpy(h), cfg.d_model,
                                   cfg.ssm)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=1e-4)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **SSD_TOL)
    assert gs.dtype == torch.float32
    if T_len < cfg.ssm.d_conv - 1:
        assert not gc[:, :cfg.ssm.d_conv - 1 - T_len].any()


def test_ssm_decode_matches_reference():
    jcfg, cfg, jp, tp = _setup()
    rng = np.random.default_rng(3)
    s = cfg.ssm
    conv_dim = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
    h = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, s.d_conv - 1, conv_dim)).astype(np.float32)
    st = rng.standard_normal((3, s.n_heads(cfg.d_model), s.head_dim,
                              s.d_state)).astype(np.float32)
    lj = jax.tree.map(lambda a: a[1], jp["runs"][0]["ssm"])
    lt = T.layer_view(tp["runs"][0]["ssm"], 1)
    want = jssm.ssm_decode(lj, *map(jnp.asarray, (h, conv, st)),
                           cfg.d_model, jcfg.ssm)
    got = ssm.ssm_decode(lt, *map(torch.from_numpy, (h, conv, st)),
                         cfg.d_model, cfg.ssm)
    # the new conv window holds this step's projection: a matmul apart
    for g, w, tol in zip(got, want, (1e-4, 1e-5, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)


@pytest.mark.parametrize("T_len", [2, 24, 64])
def test_model_prefill_and_decode_match_reference(T_len):
    """The whole reduced model: a prefill's last logits and its conv/state
    cache, then two decode steps from that cache."""
    jcfg, cfg, jp, tp = _setup()
    toks = np.random.default_rng(T_len).integers(
        0, cfg.vocab_size, (2, T_len)).astype(np.int32)
    wl, wc, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           phase="prefill")
    gl, gc, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                          phase="prefill")
    for step in range(3):
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4)
        for key, tol in (("conv", 1e-5), ("state", 1e-5)):
            assert gc[0][key].dtype == (torch.float32)
            np.testing.assert_allclose(gc[0][key].numpy(),
                                       np.asarray(wc[0][key]), atol=tol,
                                       rtol=1e-5)
        nxt = np.asarray(wl).argmax(-1).astype(np.int32)           # [2, 1]
        wl, wc, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(nxt)},
                               phase="decode", cache=wc, pos=T_len + step)
        gl, gc, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(nxt)},
                              phase="decode", cache=gc, pos=T_len + step)


def test_plan_and_cache_layout_match_reference():
    jcfg, cfg, _, _ = _setup()
    full = get_config(NAME)
    assert [dataclasses.asdict(r) for r in T.build_plan(cfg)] == [
        dataclasses.asdict(r) for r in JT.build_plan(jcfg)]
    assert [dataclasses.asdict(r) for r in T.build_plan(full)] == [
        dataclasses.asdict(r) for r in JT.build_plan(jax_get_config(NAME))]
    assert T.build_plan(full)[0].ffn_kind == "none"
    assert not T.supports_paged(cfg) and not T.supports_chunked_prefill(cfg)
    for c in (cfg, dataclasses.replace(cfg, dtype="bfloat16")):
        want = JT.init_cache(dataclasses.replace(jcfg, dtype=c.dtype), 3, 40)
        got = T.init_cache(c, 3, 40, "cpu")
        for w, g in zip(want, got):
            assert set(w) == set(g) == {"conv", "state"}
            for key in w:
                assert tuple(g[key].shape) == w[key].shape
                assert str(g[key].dtype).split(".")[1] == w[key].dtype.name
                assert not g[key].any()


def test_init_and_converter_match_reference_layout():
    """The port's own init draws the reference's tree (shapes, dtypes); the
    converter carries the reference's weights over exactly and, cast to
    bf16, keeps A_log, D and dt_bias in f32 as the reference does."""
    jcfg, cfg, jp, tp = _setup()

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}[{i}]")
        else:
            yield prefix, tree

    want = dict(leaves(jp))
    for k, t in leaves(tp):
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    for dtype in ("float32", "bfloat16"):
        jb = jax.eval_shape(lambda: JT.init_params(
            jax.random.PRNGKey(0), dataclasses.replace(jcfg, dtype=dtype)))
        ours = T.init_params(dataclasses.replace(cfg, dtype=dtype),
                             torch.Generator().manual_seed(0), "cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                for k, v in leaves(ours)} == {
            k: (v.shape, v.dtype.name) for k, v in leaves(jb)}
    bf = params_from_jax(jp, "cpu", torch.bfloat16)
    for k, t in leaves(bf):
        f32 = k.rsplit("/", 1)[1] in ("A_log", "D", "dt_bias")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), k
    bad = dict(jp, runs=[{"ln1": jp["runs"][0]["ln1"],
                          "ssm": {k: v for k, v in jp["runs"][0]["ssm"].items()
                                  if k != "conv_w"}}])
    with pytest.raises(ValueError, match="ssm"):
        params_from_jax(bad, "cpu")


def test_other_families_still_raise():
    cfg = get_config(NAME).reduced()
    for bad in (dataclasses.replace(cfg, family="hybrid"),
                dataclasses.replace(get_config("qwen3-8b").reduced(),
                                    family="ssm")):
        with pytest.raises(NotImplementedError, match="item 11"):
            T.build_plan(bad)
