"""What zamba2's shared attention block asks of the kernels, on the CPU: its
head dim of 160 (2 x 2560 / 32) through the plain versions of B5 and B6
against the Pallas ``flash_attention`` and ``decode_attention`` run in
interpret mode, through both packages' ``attn_prefill`` (the whole-prompt
threshold lowered, so the long-prompt path runs: the reference's
blockwise attention, the port's B5) and ``attn_decode`` (H = Hkv = 2,
T ~ 300, and 1024 where the reference's blockwise path needs it); the
wrappers' routes and refusals at that head dim; and B7's CUDA-core tile
opting in to the shared memory it needs at zamba2's state width (N = 64),
static arrays included.

Tolerance: |err| <= 1e-5 + 1e-5 |ref| for the kernels (f32 on both sides,
sums in another order; 160 terms a dot product), atol 1e-4 for the
attention blocks (f32 matmuls at width 320 in another order)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as tattn

D = 160
TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("T,tile", [(320, 64), (300, 100)])
def test_flash_plain_matches_pallas_at_d160(T, tile):
    """B5's plain version against the Pallas kernel in interpret mode,
    causal, at head dim 160 (T a multiple of the Pallas tile, which the
    reference's kernel requires; the plain version takes any T)."""
    rng = _rng(T)
    q, k, v = (rng.standard_normal((1, 2, T, D)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=0, bq=tile, bk=tile))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              window=0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_plain_matches_pallas_at_d160():
    """B6's plain version against the Pallas kernel in interpret mode at
    head dim 160 over a 300-position arena (no multiple of its 128-token
    tile), lengths 1, ragged and full; every entry at or past a length
    poisoned with +-99 and then NaN, which must not move the output."""
    S, H = 300, 2
    rng = _rng(7)
    lengths = np.array([1, 151, S], np.int32)
    q = rng.standard_normal((3, H, D)).astype(np.float32)
    kc = rng.standard_normal((3, S, H, D)).astype(np.float32)
    vc = rng.standard_normal((3, S, H, D)).astype(np.float32)
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths), bs=128))
    for poison in (99.0, np.nan):
        pk, pv = kc.copy(), vc.copy()
        for b, n in enumerate(lengths):
            pk[b, n:] = poison
            pv[b, n:] = -poison
        got = ops.decode_attention(*map(torch.from_numpy,
                                        (q, pk, pv, lengths)))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _block_params(seed, d_model=320, heads=2):
    """Attention weights of a block at head dim 160 (H = Hkv = 2 over a
    320-wide input, as zamba2's 32 over 5120): numpy, fan-in scaled."""
    rng = _rng(seed)
    shapes = {"wq": (d_model, heads * D), "wk": (d_model, heads * D),
              "wv": (d_model, heads * D), "wo": (heads * D, d_model)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


KW = dict(n_heads=2, n_kv_heads=2, d_head=D, theta=10000.0, window=0)


@pytest.mark.parametrize("B,T,threshold", [(1, 1024, 512), (2, 300, 2048)])
def test_attn_prefill_at_d160_matches_reference(B, T, threshold):
    """A prompt through both packages' ``attn_prefill``: 1024 tokens above
    a lowered threshold (512) — the reference's blockwise path (its
    blocks of 512 queries and 1024 keys need T a multiple of 1024) against
    the port's B5, its plain version here — and 300 tokens at the default
    threshold, dense masked attention on both sides; output and K/V."""
    p = _block_params(1)
    x = _rng(2).standard_normal((B, T, 320)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, (wk, wv) = jattn.attn_prefill(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), dense_threshold=threshold, **KW)
    got, (gk, gv) = tattn.attn_prefill(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        torch.from_numpy(pos.copy()), dense_threshold=threshold, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **BLOCK_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **BLOCK_TOL)


def test_attn_decode_at_d160_matches_reference():
    """One decode step of three rows at positions 0, 150 and 299 over a
    300-position arena through both packages' ``attn_decode``: the output
    and the arena with each row's new K/V written."""
    p = _block_params(3)
    rng = _rng(4)
    x = rng.standard_normal((3, 1, 320)).astype(np.float32)
    ck = rng.standard_normal((3, 300, 2, D)).astype(np.float32)
    cv = rng.standard_normal((3, 300, 2, D)).astype(np.float32)
    pos = np.array([0, 150, 299], np.int32)
    want, wk, wv = jattn.attn_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos), **KW)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = tattn.attn_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tk, tv, torch.from_numpy(pos), **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **BLOCK_TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **BLOCK_TOL)


def test_d160_routes():
    """bf16 at head dim 160 takes B5's tensor-core route, f32 its tile."""
    assert fa.route(torch.bfloat16, D) == "wgmma"
    assert fa.route(torch.float32, D) == "tile"
    assert D in fa._HEAD_DIMS and D not in fa._PACKED_HEAD_DIMS
    assert da._DENSE_EXTRA == {D: (1,)}


@pytest.mark.parametrize("name,heads,kv_heads,dim,match", [
    ("decode_attention", 32, 8, 160, "groups"),
    ("decode_attention", 4, 4, 96, "head dim"),
    ("flash_attention", 4, 4, 96, "head dim"),
    ("paged_decode_attention", 4, 4, 160, "head dim"),
    ("packed_prefill_attention", 4, 4, 160, "head dim")])
def test_wrappers_refuse_shapes_they_are_not_built_for(
        monkeypatch, name, heads, kv_heads, dim, match):
    """The shape checks that run before any launch (the device check made
    to pass, so they are reached on the CPU): B6 at head dim 160 takes
    only G = 1, 96 nowhere, and B1 and B2 are not built for 160."""
    monkeypatch.setattr(da, "_check_query", lambda *a: None)
    monkeypatch.setattr(fa, "_check_query", lambda *a: None)
    z = torch.zeros
    i32 = dict(dtype=torch.int32)
    q = z((1, heads, dim))
    if name == "decode_attention":
        args = (q, z((1, 8, kv_heads, dim)), z((1, 8, kv_heads, dim)),
                torch.ones(1, **i32))
    elif name == "flash_attention":
        args = (z((1, heads, 8, dim)), z((1, kv_heads, 8, dim)),
                z((1, kv_heads, 8, dim)))
    elif name == "paged_decode_attention":
        args = (q, z((2, 8, kv_heads, dim)), z((2, 8, kv_heads, dim)),
                z((1, 1), **i32), torch.ones(1, **i32))
    else:
        pages = z((2, 8, kv_heads, dim))
        args = (z((8, heads, dim)), z((8, kv_heads, dim)),
                z((8, kv_heads, dim)), pages, pages, z((1, 1), **i32),
                z(1, **i32), z(1, **i32), z(1, **i32))
    fn = getattr(da if "decode" in name else fa, name)
    before = fn.launches
    kw = {"ring": 8} if name == "packed_prefill_attention" else {}
    with pytest.raises(ValueError, match=match):
        fn(*args, **kw)
    assert fn.launches == before


def test_b7_tile_counts_its_static_shared_memory():
    """B7's CUDA-core tile (``ssd_y``) has 8 KB of static arrays (cs and
    dts, 4 heads x 256 positions of f32) beside its dynamic tiles; a block
    gets 48 KB without opting in, so wherever the two together pass it the
    launch must opt in.  At zamba2's P = 64, N = 64 the dynamic part alone
    (41.6 KB) does not: the launch passes the static bytes to
    ``allow_smem``, which weighs both."""
    src = (_build.CSRC / "ssd_chunk.cu").read_text()
    common = (_build.CSRC / "common.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    kStep, kHeads, kMaxQ = const["kStep"], const["kHeads"], const["kMaxQ"]
    kLdT = const["kRows"] + 4
    assert "constexpr int kLdT = kRows + 4;" in src
    body = src[src.index("ssd_y(const T*"):]
    assert "__shared__ float cs[kHeads][kMaxQ];" in body[:400]
    assert "__shared__ float dts[kHeads][kMaxQ];" in body[:400]
    static = 4 * 2 * kHeads * kMaxQ
    assert ("allow_smem(ssd_y<T, P>, smem, sizeof(float) * 2 * kHeads * "
            "kMaxQ)") in src
    assert "if (bytes + static_bytes <= 48 * 1024) return cudaSuccess;" \
        in common

    def dynamic(P, N):
        return 4 * (kStep * kLdT + kStep * P + N * kLdT + kStep * (N + 1))

    assert dynamic(64, 64) <= 48 * 1024 < dynamic(64, 64) + static
    for P in (16, 32, 64):
        for N in range(1, 257):
            # what the launch opts in to covers every block it makes
            assert dynamic(P, N) + static <= 227 * 1024
