"""Plain PyTorch versions of the port's kernels, with the kernels' exact
signatures.  The CPU path runs them; on the card they are what each kernel
is held against.  They repeat the kernels' arithmetic and are no yardstick
of speed."""

from __future__ import annotations

import math

import torch

from repro_torch.serving.quantized_cache import dequantize, unpack_int4

NEG_INF = -1e30
# query rows per step of ``flash_attention_ref``: its f32 scores stay at
# [B, H, 256, T] (at T = 8000 and H = 32, 262 MB) instead of [B, H, T, T]
_FLASH_REF_BQ = 256


def matmul_ref(x, w):
    """Plain version of ``matmul``: x [M,K] @ w [K,N] in f32, in x's
    dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """Plain version of ``flash_attention``: q [B,H,T,D], k/v [B,Hkv,T,D]
    (GQA), scores in f32 with scale 1/sqrt(D), masked (causal, and a sliding
    window when ``window`` > 0) to -1e30, softmax in f32, P.V with p
    rounded to the value dtype, in q's dtype.  Walks the queries in blocks
    of ``_FLASH_REF_BQ``, each against only the keys some query of the
    block can see, so any T works and no [T, T] tensor is built."""
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, T, D)
    out = torch.empty_like(q).reshape(B, Hkv, G, T, D)
    idx = torch.arange(T, device=q.device)
    for i0 in range(0, T, _FLASH_REF_BQ):
        i1 = min(i0 + _FLASH_REF_BQ, T)
        lo = max(i0 - window + 1, 0) if window > 0 else 0
        hi = i1 if causal else T
        kk, vv = k[:, :, lo:hi].float(), v[:, :, lo:hi]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, i0:i1].float(),
                         kk) / math.sqrt(D)
        rows, cols = idx[i0:i1, None], idx[None, lo:hi]
        ok = torch.ones((i1 - i0, hi - lo), dtype=torch.bool,
                        device=q.device)
        if causal:
            ok &= cols <= rows
        if window > 0:
            ok &= (rows - cols) < window
        p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1)
        out[:, :, :, i0:i1] = torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vv.float()).to(q.dtype)
    return out.reshape(B, H, T, D)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """Plain version of ``decode_attention``: q [B,H,D] against the dense
    arena [B,S,Hkv,D], positions at or past ``lengths`` masked, softmax in
    f32, P.V with p rounded to the value dtype.  Masked V rows are zeroed,
    so whatever a masked row holds never reaches the output."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.long()[:, None])                            # [B, S]
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    v = torch.where(valid[:, :, None, None], v_cache,
                    torch.zeros_like(v_cache))
    ctx = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v.float())
    return ctx.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """Plain version of ``paged_decode_attention``: gather the pages
    through ``block_tables.clamp(max=n_pages-1)``, mask positions at or past
    ``lengths`` and sentinel pages, softmax in f32, and P.V with p rounded
    to the value dtype.  Masked V rows are zeroed, so a non-finite value on
    a masked row never reaches the output."""
    B, H, D = q.shape
    n_pages, P, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    W = block_tables.shape[1]
    G = H // Hkv
    bt = block_tables.long()
    pages = bt.clamp(0, n_pages - 1)
    gk = k_pages[pages].reshape(B, W * P, Hkv, D)
    gv = v_pages[pages].reshape(B, W * P, Hkv, D)
    idx = torch.arange(W * P, device=q.device)
    valid = ((idx[None, :] < lengths.long()[:, None])
             & ~(bt >= n_pages).repeat_interleave(P, dim=1))       # [B, S]
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, gk.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    gv = torch.where(valid[:, :, None, None], gv, torch.zeros_like(gv))
    ctx = torch.einsum("bhgs,bshd->bhgd", p.to(v_pages.dtype).float(),
                       gv.float())
    return ctx.reshape(B, H, D).to(q.dtype)


def paged_decode_attention_q4_ref(q, k_pages, k_scales, v_pages, v_scales,
                                  block_tables, lengths):
    """Plain version of ``paged_decode_attention_q4``: gather the packed
    pages and their scales through ``block_tables.clamp(max=n_pages-1)``,
    unpack (low nibble = element 2i, a nibble >= 8 is value - 16) and
    dequantize in f32, mask positions at or past ``lengths`` and sentinel
    pages, softmax in f32 with scale 1/sqrt(D), and P.V in f32 (p is not
    rounded), as the reference's q4 kernel does.  Masked V rows are
    zeroed."""
    B, H, D = q.shape
    n_pages, P, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    W = block_tables.shape[1]
    G = H // Hkv
    bt = block_tables.long()
    pages = bt.clamp(0, n_pages - 1)
    gk = dequantize(unpack_int4(k_pages[pages]), k_scales[pages]).reshape(
        B, W * P, Hkv, D)
    gv = dequantize(unpack_int4(v_pages[pages]), v_scales[pages]).reshape(
        B, W * P, Hkv, D)
    idx = torch.arange(W * P, device=q.device)
    valid = ((idx[None, :] < lengths.long()[:, None])
             & ~(bt >= n_pages).repeat_interleave(P, dim=1))       # [B, S]
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, gk) * (1.0 / math.sqrt(D))
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    gv = torch.where(valid[:, :, None, None], gv, torch.zeros_like(gv))
    ctx = torch.einsum("bhgs,bshd->bhgd", p, gv)
    return ctx.reshape(B, H, D).to(q.dtype)


def gemv_ref(x, w, scale=None):
    """Plain version of ``gemv``: x [M,K] @ w [K,N] in f32, times the
    per-column ``scale`` applied to the f32 product (the kernel's epilogue
    dequant), in x's dtype."""
    out = x.float() @ w.float()
    if scale is not None:
        out = out * scale.float()
    return out.to(x.dtype)


def packed_prefill_attention_ref(q, k_new, v_new, k_pages, v_pages,
                                 block_tables, seg_starts, seg_offsets,
                                 seg_lengths, *, ring: int, window: int = 0):
    """Plain version of ``packed_prefill_attention``: build each segment's
    history positions exactly as attn_chunk_packed_paged does
    (src/repro/models/attention.py:697-703) and run the port's
    ``_packed_attention``.  Rows outside every real segment are zero, as
    the kernel leaves them."""
    from repro_torch.models.attention import (_gather_history,
                                              _packed_attention,
                                              make_packed_segs)

    T, H, D = q.shape
    Hkv = k_pages.shape[2]
    N = block_tables.shape[0]
    prev_k, prev_v, prev_pos = _gather_history(k_pages, v_pages,
                                               block_tables, seg_offsets,
                                               ring)
    seg = make_packed_segs(seg_starts, seg_offsets, seg_lengths,
                           torch.arange(N, device=q.device), T)
    ctx = _packed_attention(q, k_new, v_new, prev_k, prev_v, prev_pos, seg,
                            n_heads=H, n_kv_heads=Hkv, d_head=D,
                            window=window, softcap=0.0)
    return ctx.reshape(T, H, D).to(q.dtype)


def ssd_chunk_ref(x, dt, A, Bm, Cm):
    """Plain version of ``ssd_chunk``: the Mamba-2 SSD inside each of nc
    stacked chunks for one B/C group, before the inter-chunk recurrence.
    x [nc,H,Q,P], dt [nc,H,Q], A [H], Bm/Cm [nc,Q,N] -> (y [nc,H,Q,P],
    states [nc,H,N,P]), both f32, all arithmetic f32:

        cs = cumsum(dt A);  L[i, j] = exp(cs_i - cs_j) for j <= i, else 0
        y = ((C B^T) o L) (dt x);  state = B^T (exp(cs_last - cs) dt x)

    ``exp`` sees only j <= i (above the diagonal cs_i - cs_j may be
    positive and overflow: ``models.ssm._segsum`` puts -inf there).  L is
    materialised as [nc, H, Q, Q] f32."""
    from repro_torch.models.ssm import _segsum

    dtf = dt.float()
    dA = dtf * A.float()[None, :, None]                          # [nc,H,Q]
    cs = torch.cumsum(dA, dim=-1)
    xb = x.float() * dtf[..., None]                              # [nc,H,Q,P]
    cb = Cm.float() @ Bm.float().transpose(-1, -2)               # [nc,Q,Q]
    y = (cb[:, None] * torch.exp(_segsum(dA))) @ xb
    decay = torch.exp(cs[..., -1:] - cs)                         # [nc,H,Q]
    states = Bm.float().transpose(-1, -2)[:, None] @ (xb * decay[..., None])
    return y, states
