"""B4 on the decode walk, on the CPU: the arithmetic of its int4 walk —
the codes unpacked by the shift pair, each token's scales applied outside
the inner sums (s = (sk (q . k_codes)) / sqrt(D), acc += (p sv) v_codes),
p and the accumulators in f32 — emulated in PyTorch and held against the
JAX package's Pallas ``paged_decode_attention_q4`` (interpret mode) under
the card's bounds (``chip_smoke.tolerance``, unchanged), over pools whose
block tables list pages out of order with an unallocated page inside a
row, lengths at the edges of the packed walk's stage and split, and NaN
scales on every masked row.  The kernel itself runs only on the card
(``chip_smoke.py``)."""

import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import \
    paged_decode_attention_q4 as jax_paged_decode_q4
from repro_torch.kernels import decode_attention as da
from repro_torch.serving.quantized_cache import unpack_int4

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SMS = 132


def _case(rng, H, Hkv, D, P, lengths):
    """Packed pages of random nibble bytes for ``lengths`` (pages out of
    order, the second page of the last row unallocated), scales in [0.05,
    0.3]; the scales of every masked row (past a length, on a page no row
    uses) NaN."""
    B, W = len(lengths), -(-max(lengths) // P) + 1
    n_pages = sum(-(-n // P) for n in lengths) + 2
    order = list(rng.permutation(n_pages - 1))
    bt = np.full((B, W), n_pages, np.int32)
    for b, n in enumerate(lengths):
        for i in range(-(-n // P)):
            bt[b, i] = order.pop()
    if lengths[-1] > P:
        bt[B - 1, 1] = n_pages
    kp = rng.integers(0, 256, (n_pages, P, Hkv, D // 2), dtype=np.uint8)
    vp = rng.integers(0, 256, (n_pages, P, Hkv, D // 2), dtype=np.uint8)
    ks = rng.uniform(0.05, 0.3, (n_pages, P, Hkv)).astype(np.float32)
    vs = rng.uniform(0.05, 0.3, (n_pages, P, Hkv)).astype(np.float32)
    live = np.zeros((n_pages, P), bool)
    for b, n in enumerate(lengths):
        for t in range(n):
            page = bt[b, t // P]
            if page < n_pages:
                live[page, t % P] = True
    ks[~live] = np.nan
    vs[~live] = np.nan
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, kp, ks, vp, vs, bt, np.array(lengths, np.int32)


def _walk_emulation(q, kp, ks, vp, vs, bt, lengths):
    """B4's arithmetic in f32: tokens off the table or past a length read
    as zero codes and zero scales and are masked; s = (sk (q . k_codes)) /
    sqrt(D); p = exp(s - max) over the valid tokens; out = (sum_t (p_t sv_t)
    v_codes_t) / max(sum_t p_t, 1e-30), in q's dtype."""
    B, H, D = q.shape
    n_pages, P, Hkv = kp.shape[:3]
    W = bt.shape[1]
    G = H // Hkv
    allocated = bt.long() < n_pages
    pages = bt.long().clamp(0, n_pages - 1)
    valid = ((torch.arange(W * P)[None, :] < lengths.long()[:, None])
             & allocated.repeat_interleave(P, dim=1))              # [B, S]

    def gather(codes, scales):
        c = unpack_int4(codes[pages]).float().reshape(B, W * P, Hkv, D)
        s = scales[pages].reshape(B, W * P, Hkv)
        c = torch.where(valid[..., None, None], c, 0.0)
        return c, torch.where(valid[..., None], s, 0.0)
    kc, sk = gather(kp, ks)
    vc, sv = gather(vp, vs)
    qg = q.float().reshape(B, Hkv, G, D)
    dot = torch.einsum("bhgd,bshd->bhgs", qg, kc)
    s = (dot * sk.permute(0, 2, 1)[:, :, None, :]) * (1.0 / math.sqrt(D))
    s = torch.where(valid[:, None, None, :], s, -float("inf"))
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    ps = p * sv.permute(0, 2, 1)[:, :, None, :]
    acc = torch.einsum("bhgs,bshd->bhgd", ps, vc)
    return (acc / l.clamp_min(1e-30)).reshape(B, H, D).to(q.dtype)


def _edge_lengths(D, Hkv, longest):
    """1, a stage of the packed walk +-1, its split for this call +-1, and
    the longest (``chip_smoke.decode_edge_lengths``'s rule)."""
    p = da.plan(da.PACKED, D, 1, Hkv, 8, 4 * longest, SMS)
    w, sp = p.warp_tokens, da.split_for(p, longest, Hkv)
    return [1, w - 1, w, w + 1, sp - 1, sp, sp + 1, longest]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D", [(4, 1, 16), (8, 2, 128), (4, 4, 128)])
def test_scale_folding_matches_pallas(H, Hkv, D, dtype):
    """The folded scales agree with the Pallas kernel, which dequantizes
    every code before its products, within the card's bound for B4 (f32:
    1e-4; bf16 q: one output rounding a side plus the f32 sums' term), and
    no NaN scale of a masked row reaches the output."""
    rng = np.random.default_rng(H * 100 + Hkv * 10 + D)
    longest = 700 if D == 16 else 300
    arrays = _case(rng, H, Hkv, D, 16, _edge_lengths(D, Hkv, longest))
    args = [torch.from_numpy(a) for a in arrays]
    args[0] = args[0].to(dtype)
    want = torch.from_numpy(np.array(jax_paged_decode_q4(
        jnp.asarray(args[0].float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        *(jnp.asarray(a) for a in arrays[1:]), interpret=True)
        .astype(jnp.float32)))
    got = _walk_emulation(*args)
    assert got.dtype == dtype and torch.isfinite(got).all()
    name = chip_smoke.dtype_name(args[0])
    tol, A = chip_smoke.tolerance(torch, "paged_decode_attention_q4", args,
                                  {}, name)
    err, ok, _ = chip_smoke.close(torch, got, want.to(dtype), name, A, tol)
    assert ok, err


def test_edge_lengths_cross_the_packed_stage_and_split():
    """At D = 128 a packed stage is 24 tokens (4 KB holds 30 tokens' K and
    V rows and scales; 8 rows a pass of the copying lanes) and the split a
    multiple of 96; the edge lengths straddle both."""
    lengths = _edge_lengths(128, 2, 300)
    assert lengths[:4] == [1, 23, 24, 25]
    p = da.plan(da.PACKED, 128, 1, 2, 8, 1200, SMS)
    assert lengths[5] % p.quantum == 0 and lengths[5] == da.split_for(p, 300,
                                                                       2)
