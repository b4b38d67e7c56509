"""The port's quantized-serving building blocks against the JAX package's on
the CPU: the int8/int4 quantizers and the nibble packing (bit-exact on
identical inputs), ``quantize_params``, the plain versions of the int8
GEMV and the int4 paged decode kernel against the Pallas kernels in
interpret mode (atol 1e-5), ``layers.matmul`` on ``{"q","scale"}`` leaves
and its GEMV route count, the int8/int4 KV pool layouts, the converter on
a quantized tree, and the dispatcher's device rule for the two new
kernels.  Inputs are drawn with numpy; everything is f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.kernels.decode_attention import \
    paged_decode_attention_q4 as jax_paged_decode_q4
from repro.kernels.gemv_cid import gemv as jax_gemv
from repro.models import layers as jl
from repro.models.transformer import init_params as jax_init_params
from repro.serving import kv_pool as jax_kv_pool
from repro.serving import quantized_cache as jqc
from repro.serving import quantized_weights as jqw
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as cuda_decode
from repro_torch.kernels import gemv_cid as cuda_gemv
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import kv_pool
from repro_torch.serving import quantized_cache as tqc
from repro_torch.serving import quantized_weights as tqw

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


# -- quantizers: bit-exact on identical inputs ---------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_quantize_token_matches_reference(scale):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * scale).astype(np.float32)
    x[0, 0] = 0.0                              # an all-zero vector: 1e-8 floor
    x[1, 2, :4] = [0.5, -0.5, 1.5, -2.5]       # halves round to even
    for dim in (-1, 1):
        q, s = tqc.quantize_token(_t(x), dim)
        jq, js = jqc.quantize_token(jnp.asarray(x), dim)
        np.testing.assert_array_equal(_np(q), np.asarray(jq))
        np.testing.assert_array_equal(_np(s), np.asarray(js))
        np.testing.assert_array_equal(_np(tqc.dequantize(q, s, dim)),
                                      np.asarray(jqc.dequantize(jq, js, dim)))
    q4, s4 = tqc.quantize_token_int4(_t(x))
    jq4, js4 = jqc.quantize_token_int4(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q4), np.asarray(jq4))
    np.testing.assert_array_equal(_np(s4), np.asarray(js4))
    assert int(q4.abs().max()) <= 7


def test_pack_unpack_int4_match_reference():
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, (3, 5, 16), dtype=np.int8)
    packed = tqc.pack_int4(_t(q))
    jpacked = jqc.pack_int4(jnp.asarray(q))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (3, 5, 8)
    np.testing.assert_array_equal(_np(packed), np.asarray(jpacked))
    # element 2i rides the low nibble
    assert int(packed[0, 0, 0]) == (int(q[0, 0, 0]) & 0xF) | (
        (int(q[0, 0, 1]) & 0xF) << 4)
    raw = rng.integers(0, 256, (4, 7), dtype=np.uint8)
    np.testing.assert_array_equal(_np(tqc.unpack_int4(_t(raw))),
                                  np.asarray(jqc.unpack_int4(jnp.asarray(raw))))
    np.testing.assert_array_equal(_np(tqc.unpack_int4(packed)), q)
    with pytest.raises(ValueError):
        tqc.pack_int4(torch.zeros((2, 7), dtype=torch.int8))


@pytest.mark.parametrize("shape", [(64, 33), (3, 48, 20)])
def test_quantize_weight_matches_reference(shape):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    w[..., 0] = 0.0                            # an all-zero column
    got = tqw.quantize_weight(_t(w))
    want = jqw.quantize_weight(jnp.asarray(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    for k in ("q", "scale"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    np.testing.assert_array_equal(_np(tqw.dequantize_weight(got)),
                                  np.asarray(jqw.dequantize_weight(want)))
    # from bf16 the port quantizes the same f32 values the reference does
    wb = _t(w).to(torch.bfloat16)
    got_b = tqw.quantize_weight(wb)
    want_b = jqw.quantize_weight(jnp.asarray(wb.float().numpy()))
    np.testing.assert_array_equal(_np(got_b["q"]), np.asarray(want_b["q"]))


def test_quantize_params_leaves_moe_and_floor():
    big = torch.ones((64, 64))
    tree = {"runs": [{"attn": {"wq": big, "q_norm": torch.ones(64)},
                      "moe": {"wi_gate": big}}],
            "embed": big, "lm_head": big}
    out = tqw.quantize_params(tree, min_size=0)
    assert set(out["runs"][0]["attn"]["wq"]) == {"q", "scale"}
    assert out["runs"][0]["moe"]["wi_gate"] is big
    assert out["runs"][0]["attn"]["q_norm"] is tree["runs"][0]["attn"]["q_norm"]
    assert out["embed"] is big and out["lm_head"] is big
    kept = tqw.quantize_params(tree, min_size=big.numel() + 1)
    assert kept["runs"][0]["attn"]["wq"] is big
    assert tqw.quantize_params(tree)["runs"][0]["attn"]["wq"] is big
    assert tqw.MATMUL_LEAVES == jqw.MATMUL_LEAVES


# -- plain int8 GEMV vs the Pallas kernel (interpret mode) ----------------------

@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("K,N", [(256, 512), (1100, 300), (2500, 700)])
@pytest.mark.parametrize("quantized", [True, False])
def test_gemv_ref_matches_pallas(M, K, N, quantized):
    """Ragged K (masked K tail) and N (dropped N tail) included."""
    rng = np.random.default_rng(M * 7 + K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    if quantized:
        wq = jqw.quantize_weight(jnp.asarray(w))
        q, s = np.asarray(wq["q"]), np.asarray(wq["scale"])
        want = jax_gemv(jnp.asarray(x), wq["q"], wq["scale"], interpret=True)
        got = ref.gemv_ref(_t(x), _t(q), _t(s))
    else:
        want = jax_gemv(jnp.asarray(x), jnp.asarray(w), interpret=True)
        got = ref.gemv_ref(_t(x), _t(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)


# -- plain int4 paged decode vs the Pallas kernel (interpret mode) ---------------

def _q4_case(rng, H, Hkv, D, P):
    """Ragged lengths over a shared pool of random nibble bytes, one
    sentinel page inside a row's length; the scale pages of unused pages
    (including the one a sentinel clamps to) and of rows past each length
    poisoned with NaN, and their bytes random."""
    B, W, n_pages = 3, 5, 20
    lengths = np.array([W * P, 2 * P + 1, 3], np.int32)
    order = list(rng.permutation(n_pages - 1))
    bt = np.full((B, W), n_pages, np.int32)
    for b in range(B):
        for i in range(-(-int(lengths[b]) // P)):
            bt[b, i] = order.pop()
    bt[0, 2] = n_pages                        # skipped whole
    kp = rng.integers(0, 256, (n_pages, P, Hkv, D // 2), dtype=np.uint8)
    vp = rng.integers(0, 256, (n_pages, P, Hkv, D // 2), dtype=np.uint8)
    ks = rng.uniform(0.05, 0.3, (n_pages, P, Hkv)).astype(np.float32)
    vs = rng.uniform(0.05, 0.3, (n_pages, P, Hkv)).astype(np.float32)
    pks, pvs = ks.copy(), vs.copy()
    used = set(bt.ravel().tolist())
    for p in range(n_pages):
        if p not in used:
            pks[p] = np.nan
            pvs[p] = np.nan
    for b in range(B):
        n = int(lengths[b])
        last = bt[b, (n - 1) // P]
        if n % P and last < n_pages:
            pks[last, n % P:] = np.nan
            pvs[last, n % P:] = np.nan
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, kp, ks, vp, vs, pks, pvs, bt, lengths


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1), (8, 2)])
def test_paged_decode_q4_ref_matches_pallas(H, Hkv, D, P):
    rng = np.random.default_rng(H * 1000 + Hkv * 100 + D + P)
    q, kp, ks, vp, vs, pks, pvs, bt, lengths = _q4_case(rng, H, Hkv, D, P)
    want = np.asarray(jax_paged_decode_q4(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(ks), jnp.asarray(vp),
        jnp.asarray(vs), jnp.asarray(bt), jnp.asarray(lengths),
        interpret=True))
    got = _np(ref.paged_decode_attention_q4_ref(
        _t(q), _t(kp), _t(ks), _t(vp), _t(vs), _t(bt), _t(lengths)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # NaN scales on every masked row and unused page change nothing
    poisoned = _np(ref.paged_decode_attention_q4_ref(
        _t(q), _t(kp), _t(pks), _t(vp), _t(pvs), _t(bt), _t(lengths)))
    assert np.isfinite(poisoned).all()
    np.testing.assert_allclose(poisoned, got, atol=1e-6, rtol=0)


# -- layers.matmul on quantized leaves ------------------------------------------

@pytest.mark.parametrize("T", [1, 8, 9])
def test_matmul_quantized_leaf(T):
    """Token dim <= 8 takes the GEMV route (one count per call), above it
    the dequantized product; both against the reference's matmul."""
    rng = np.random.default_rng(10 + T)
    x = rng.standard_normal((3, T, 48)).astype(np.float32)
    wq = jqw.quantize_weight(jnp.asarray(
        (rng.standard_normal((48, 24)) / 7).astype(np.float32)))
    want = jl.matmul(jnp.asarray(x), wq)
    tl.reset_gemv_route_count()
    got = tl.matmul(_t(x), {"q": _t(np.asarray(wq["q"])),
                            "scale": _t(np.asarray(wq["scale"]))})
    assert tl.gemv_route_count() == (1 if T <= tl.GEMV_TOKEN_DIM_MAX else 0)
    assert tl.GEMV_TOKEN_DIM_MAX == jl.GEMV_TOKEN_DIM_MAX
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)


# -- KV pool layouts --------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_pool_layout_matches_reference(kv_dtype):
    jcfg = dataclasses.replace(jax_get_config("qwen3-8b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              dtype="float32")
    ours = kv_pool.KVPool(cfg, n_slots=2, n_pages=16, page_size=8,
                          kv_dtype=kv_dtype, device="cpu")
    theirs = jax_kv_pool.KVPool(jcfg, n_slots=2, n_pages=16, page_size=8,
                                kv_dtype=kv_dtype)
    for c, jc in zip(ours.caches, theirs.caches):
        assert set(c) == set(jc) == {"k", "k_scale", "v", "v_scale"}
        for name in c:
            assert tuple(c[name].shape) == jc[name].shape
            assert str(c[name].dtype).split(".")[-1] == str(jc[name].dtype)
            assert not c[name].any()
    assert ours.page_bytes(0) == theirs.page_bytes(0)
    assert ours.total_bytes() == theirs.total_bytes()


def test_pool_rejects_odd_int4_head_dim():
    cfg = dataclasses.replace(get_config("llama2-7b").reduced(),
                              dtype="float32", d_head=15)
    with pytest.raises(ValueError, match="odd"):
        kv_pool.KVPool(cfg, n_slots=1, n_pages=4, page_size=4,
                       kv_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        kv_pool.KVPool(cfg, n_slots=1, n_pages=4, page_size=4,
                       kv_dtype="fp8", device="cpu")


def test_converter_keeps_quantized_leaves():
    jcfg = dataclasses.replace(jax_get_config("llama2-7b").reduced(),
                               dtype="float32")
    jp = jqw.quantize_params(jax_init_params(jax.random.PRNGKey(0), jcfg),
                             min_size=0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                         dtype=torch.bfloat16)
    wq = tp["runs"][0]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        _np(wq["q"]), np.asarray(jp["runs"][0]["attn"]["wq"]["q"]))
    assert tp["embed"].dtype == torch.bfloat16


# -- dispatch: CPU tensors take the plain versions, wrappers refuse them -------------

def test_ops_dispatch_the_new_kernels_by_device():
    rng = np.random.default_rng(4)
    q, kp, ks, vp, vs, _, _, bt, lengths = _q4_case(rng, 4, 2, 16, 4)
    args = (_t(q), _t(kp), _t(ks), _t(vp), _t(vs), _t(bt), _t(lengths))
    torch.testing.assert_close(ops.paged_decode_attention_q4(*args),
                               ref.paged_decode_attention_q4_ref(*args),
                               atol=0, rtol=0)
    x = _t(rng.standard_normal((2, 32)).astype(np.float32))
    w = _t(rng.integers(-127, 128, (32, 16), dtype=np.int8))
    s = _t(rng.uniform(0.01, 0.1, 16).astype(np.float32))
    torch.testing.assert_close(ops.gemv(x, w, s), ref.gemv_ref(x, w, s),
                               atol=0, rtol=0)
    n_q4 = cuda_decode.paged_decode_attention_q4.launches
    n_gemv = cuda_gemv.gemv.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_decode.paged_decode_attention_q4(*args)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gemv.gemv(x, w, s)
    assert cuda_decode.paged_decode_attention_q4.launches == n_q4
    assert cuda_gemv.gemv.launches == n_gemv
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.gemv(torch.zeros((1, 4), device="meta"), None)


@pytest.mark.parametrize("K,N,itemsize", [(4096, 1024, 1), (12288, 4096, 1),
                                          (4096, 11008, 1), (100, 40, 4)])
def test_gemv_chunking_covers_k(K, N, itemsize):
    """Both routes' K split covers K exactly once, with enough chunks to
    give the small-N layers a wave of blocks.  Tile: chunks of 16-row
    multiples, at most 2048 rows (x's chunk sits in shared memory).  Tensor
    cores: chunks of whole 64-row ring stages, (128-column tile, chunk)
    units for a persistent grid."""
    kc, n = cuda_gemv.chunking(K, N, itemsize)
    assert kc % 16 == 0 and 0 < kc <= 2048
    assert (n - 1) * kc < K <= n * kc
    tiles = -(-N // (8 * 16 // itemsize))
    if K >= 4096:
        assert tiles * n >= 128
    kc, n = cuda_gemv.chunking(K, N, itemsize, "wgmma")
    assert kc % 64 == 0 and (n - 1) * kc < K <= n * kc
    if K >= 4096:
        assert -(-N // 128) * n >= 128
