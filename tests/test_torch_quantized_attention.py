"""The port's quantized attention against the JAX package's on the CPU: the
s8 x s8 sweep ``_q8_sweep``, the int8 and packed-int4 paged decode steps
and the quantized packed-prefill step, on pools pre-filled with the same
random codes on both sides, GQA and MHA, with qk-norm, a softcapped case,
an inactive row and a sentinel page.  Outputs must agree to 1e-5.  The
written pools come out of two projections that differ by f32 rounding, and
a rounding that lands on the other side of a .5 moves one code by one
step: pools are compared by dequantized value, every entry within one
quantization step and at most 2% of them off by more than 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.serving import quantized_cache as jqc
from repro_torch.models import attention as tattn
from repro_torch.serving import quantized_cache as tqc

ATOL = 1e-5
D, DM, P, N_PAGES, W = 16, 32, 4, 12, 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(rng, H, Hkv):
    p = {"wq": rng.standard_normal((DM, H * D)),
         "wk": rng.standard_normal((DM, Hkv * D)),
         "wv": rng.standard_normal((DM, Hkv * D)),
         "wo": rng.standard_normal((H * D, DM)),
         "q_norm": 1.0 + 0.1 * rng.standard_normal(D),
         "k_norm": 1.0 + 0.1 * rng.standard_normal(D)}
    p = {k: (v / np.sqrt(v.shape[0]) if k.startswith("w") else v
             ).astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


def _pool(rng, Hkv, q4):
    """A pool of random codes and scales, the same on both sides."""
    width = D // 2 if q4 else D
    if q4:
        k = rng.integers(0, 256, (N_PAGES, P, Hkv, width), dtype=np.uint8)
        v = rng.integers(0, 256, (N_PAGES, P, Hkv, width), dtype=np.uint8)
    else:
        k = rng.integers(-127, 128, (N_PAGES, P, Hkv, width), dtype=np.int8)
        v = rng.integers(-127, 128, (N_PAGES, P, Hkv, width), dtype=np.int8)
    ks = rng.uniform(0.01, 0.05, (N_PAGES, P, Hkv)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (N_PAGES, P, Hkv)).astype(np.float32)
    cache = {"k": k, "k_scale": ks, "v": v, "v_scale": vs}
    return ({k: jnp.asarray(a) for k, a in cache.items()},
            {k: _t(a) for k, a in cache.items()})


def _assert_pools_close(tc, jc, q4):
    off = total = 0
    for name in ("k", "v"):
        js = np.asarray(jc[f"{name}_scale"])
        ts = tc[f"{name}_scale"].numpy()
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
        jq, tq = np.asarray(jc[name]), tc[name]
        if q4:
            jq = np.asarray(jqc.unpack_int4(jnp.asarray(jq)))
            tq = tqc.unpack_int4(tq)
        dj = jq.astype(np.float32) * js[..., None]
        dt = tq.numpy().astype(np.float32) * ts[..., None]
        diff = np.abs(dt - dj)
        assert (diff <= js[..., None] * 1.001 + 1e-6).all(), \
            f"{name}: a code moved by more than one step"
        off += int((diff > 1e-6).sum())
        total += diff.size
    assert off <= 0.02 * total, f"{off} of {total} pool entries differ"


def _table(rng, B):
    """Block tables: row 0 full with a sentinel page inside its length, row
    1 short, the last row inactive (all sentinels: its write drops)."""
    order = list(rng.permutation(N_PAGES))
    bt = np.full((B, W), N_PAGES, np.int32)
    for i in range(W):
        bt[0, i] = order.pop()
    bt[0, 1] = N_PAGES
    for i in range(2):
        bt[1, i] = order.pop()
    pos = np.array([W * P - 1, P + 2] + [0] * (B - 2), np.int32)
    return bt, pos


# -- the s8 x s8 sweep ---------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
def test_q8_sweep_matches_reference(H, Hkv, softcap):
    rng = np.random.default_rng(H + Hkv + int(softcap))
    B, S = 3, 40
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    ck = rng.integers(-127, 128, (B, S, Hkv, D), dtype=np.int8)
    cv = rng.integers(-127, 128, (B, S, Hkv, D), dtype=np.int8)
    cks = rng.uniform(0.01, 0.05, (B, S, Hkv)).astype(np.float32)
    cvs = rng.uniform(0.01, 0.05, (B, S, Hkv)).astype(np.float32)
    valid = rng.random((B, S)) < 0.8
    valid[:, 0] = True
    kw = dict(n_heads=H, n_kv_heads=Hkv, d_head=D, softcap=softcap)
    want = jattn._q8_sweep(*map(jnp.asarray, (q, ck, cks, cv, cvs, valid)),
                           **kw)
    got = tattn._q8_sweep(*map(_t, (q, ck, cks, cv, cvs, valid)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_q8_sweep_sums_p_v_exactly_past_f32():
    """Equal scores give p_q = 127 everywhere; with every v code 127 the
    s8 x s8 P.V sum is 127^2 * S = 33 048 321 at S = 2049 — odd and above
    2^24, so an f32 sum could not hold it.  The reference sums in int32."""
    B, Hkv, S = 1, 1, 2049
    q = np.zeros((B, 1, 2, D), np.float32)
    ck = np.ones((B, S, Hkv, D), np.int8)
    cv = np.full((B, S, Hkv, D), 127, np.int8)
    cks = np.full((B, S, Hkv), 0.01, np.float32)
    cvs = np.full((B, S, Hkv), 0.02, np.float32)
    valid = np.ones((B, S), bool)
    kw = dict(n_heads=2, n_kv_heads=Hkv, d_head=D, softcap=0.0)
    want = np.asarray(jattn._q8_sweep(
        *map(jnp.asarray, (q, ck, cks, cv, cvs, valid)), **kw))
    got = tattn._q8_sweep(*map(_t, (q, ck, cks, cv, cvs, valid)),
                          **kw).numpy()
    np.testing.assert_array_equal(got, want)
    f32_sum = np.float32(127 * 127) * np.float32(S)
    assert int(f32_sum) != 127 * 127 * S        # f32 cannot hold the sum


# -- paged decode steps ----------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1)])
@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
def test_quantized_decode_matches_reference(q4, H, Hkv, qk_norm, softcap):
    rng = np.random.default_rng(100 * q4 + 10 * H + Hkv + qk_norm)
    jp, tp = _params(rng, H, Hkv)
    jc, tc = _pool(rng, Hkv, q4)
    B = 3
    bt, pos = _table(rng, B)
    x = rng.standard_normal((B, 1, DM)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, d_head=D, theta=10_000.0,
              window=0, softcap=softcap, qk_norm=qk_norm)
    jfn = jattn.attn_decode_q4_paged if q4 else jattn.attn_decode_q8_paged
    tfn = tattn.attn_decode_q4_paged if q4 else tattn.attn_decode_q8_paged
    want, jc = jfn(jp, jnp.asarray(x), jc, jnp.asarray(bt), jnp.asarray(pos),
                   **kw)
    got, tc = tfn(tp, _t(x), tc, _t(bt), _t(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    _assert_pools_close(tc, jc, q4)


# -- quantized packed prefill --------------------------------------------------------------

def _stream():
    """Two segments at 8-aligned starts: slot 0 resumes at offset 5 with
    history, slot 1 starts fresh; one pad segment (start == T)."""
    T = 24
    starts = np.array([0, 16, T], np.int32)
    offs = np.array([5, 0, 0], np.int32)
    lens = np.array([11, 6, 0], np.int32)
    slots = np.array([0, 1, 3], np.int32)
    return T, starts, offs, lens, slots


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("H,Hkv,qk_norm", [(4, 4, False), (8, 2, True)])
@pytest.mark.parametrize("q4", [False, True], ids=["int8", "int4"])
def test_quantized_packed_prefill_matches_reference(q4, H, Hkv, qk_norm,
                                                    softcap):
    rng = np.random.default_rng(200 + 100 * q4 + H + Hkv + int(softcap))
    jp, tp = _params(rng, H, Hkv)
    jc, tc = _pool(rng, Hkv, q4)
    T, starts, offs, lens, slots = _stream()
    order = list(rng.permutation(N_PAGES))
    # as wide as the pool, as the engine's tables are (W * P >= the ring)
    bt = np.full((4, N_PAGES), N_PAGES, np.int32)
    for i in range(4):                       # 16 positions for slot 0
        bt[0, i] = order.pop()
    for i in range(2):                       # 6 positions for slot 1
        bt[1, i] = order.pop()
    x = rng.standard_normal((1, T, DM)).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=Hkv, d_head=D, theta=10_000.0,
              window=0, softcap=softcap, qk_norm=qk_norm)
    jseg = jattn.make_packed_segs(*map(jnp.asarray, (starts, offs, lens,
                                                     slots)), T)
    tseg = tattn.make_packed_segs(*map(_t, (starts, offs, lens, slots)), T)
    want, jc = jattn.attn_chunk_packed_paged(jp, jnp.asarray(x), jseg, jc,
                                             jnp.asarray(bt), **kw)
    got, tc = tattn.attn_chunk_packed_paged(tp, _t(x), tseg, tc, _t(bt),
                                            **kw)
    real = np.concatenate([np.arange(s, s + n) for s, n in
                           zip(starts[:2], lens[:2])])
    np.testing.assert_allclose(got.numpy()[0, real],
                               np.asarray(want)[0, real], atol=ATOL, rtol=0)
    _assert_pools_close(tc, jc, q4)
