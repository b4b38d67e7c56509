"""Attention for serving (port of the dense-attention part of
src/repro/models/attention.py): over the paged KV pool, and over the
dense per-slot decode arena.

* ``attn_prefill`` — whole-prompt attention: dense masked attention up to
  ``dense_threshold`` tokens, the flash-attention kernel above it.
* ``attn_decode`` — one new token per row against the dense arena
  [B, S, Hkv, D], through the dense flash-decode kernel;
  ``attn_chunk_packed`` — a packed prefill stream against the dense arena,
  through the packed-prefill kernel with the arena viewed as one S-token
  page per slot.
* ``attn_decode_paged`` — one new token per sequence against a float pool,
  through the paged flash-decode kernel (HALO's CiD phase);
  ``attn_decode_q8_paged`` against an int8 pool (both contractions s8 x s8,
  exact integer sums) and ``attn_decode_q4_paged`` against a packed-int4
  pool, through the int4 paged flash-decode kernel.
* ``attn_chunk_packed_paged`` — one tick's prefill chunks as a flat token
  stream, through the packed-prefill kernel (HALO's CiM phase); a quantized
  pool is dequantized to the activation dtype for it, and the chunk's K/V
  are quantized on the way in.

The serving paths update the pool or arena IN PLACE: the reference
scatters functionally with ``.at[...].set(..., mode="drop")`` and relies
on out-of-range sentinel indices being dropped; here the dropped rows are
filtered out before an in-place ``index_put_`` (an out-of-range index is
an error on the CPU and undefined on CUDA).  The pools and arenas are
zero-initialized and only ever written with finite values, and every read
path masks unwritten entries.

Quantized pools carry ``k_scale``/``v_scale`` pages ([n_pages, P, Hkv]
f32) beside ``k``/``v``: int8 [n_pages, P, Hkv, D], or uint8 nibble pairs
[n_pages, P, Hkv, D/2] for int4 (``serving/quantized_cache.py``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops as _kops
from repro_torch.models.layers import apply_rope, head_rmsnorm, matmul
from repro_torch.serving.quantized_cache import (dequantize, pack_int4,
                                                 quantize_token,
                                                 quantize_token_int4,
                                                 unpack_int4)

NEG_INF = -1e30
_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# qkv projection (shared between phases)
# ---------------------------------------------------------------------------

def _project_qkv(params, x, n_heads, n_kv_heads, d_head, positions, theta,
                 qk_norm: bool):
    """x [B,T,d] -> q [B,T,H,D], k/v [B,T,Hkv,D], qk-norm then RoPE at
    ``positions`` [B,T] (the reference's sharding constraints are dropped:
    one card needs none)."""
    B, T = x.shape[0], x.shape[1]
    q = matmul(x, params["wq"]).reshape(B, T, n_heads, d_head)
    k = matmul(x, params["wk"]).reshape(B, T, n_kv_heads, d_head)
    v = matmul(x, params["wv"]).reshape(B, T, n_kv_heads, d_head)
    if qk_norm:
        q = head_rmsnorm(params["q_norm"], q)
        k = head_rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def _maybe_softcap(scores, softcap: float):
    if softcap and softcap > 0.0:
        return softcap * torch.tanh(scores / softcap)
    return scores


def _paged_ring(window, n_pages: int, page_size: int) -> int:
    """Logical ring span of a paged run: min(window, pool capacity)."""
    capacity = n_pages * page_size
    w = int(window)
    return min(w, capacity) if w > 0 else capacity


def _dequantized_pool(cache, dtype):
    """A quantized pool's K and V pages dequantized to ``dtype``
    ([n_pages, P, Hkv, D] each).  Dequantizing is elementwise, so reading
    history from these pages gives exactly the reference's
    ``dequantize(raw[pages], scale[pages]).astype(dtype)``
    (src/repro/models/attention.py:683-690)."""
    raw_k, raw_v = cache["k"], cache["v"]
    if raw_k.dtype == torch.uint8:                  # packed int4
        raw_k, raw_v = unpack_int4(raw_k), unpack_int4(raw_v)
    return (dequantize(raw_k, cache["k_scale"]).to(dtype),
            dequantize(raw_v, cache["v_scale"]).to(dtype))


def _write_pool(cache, write, k, v) -> None:
    """Write the selected tokens' K/V ([n, Hkv, D]) into the pool at
    ``write`` = (token rows, pages, offsets), in place; a quantized pool
    stores them quantized per (token, kv head) with their scales — packed
    int4 on a uint8 pool, int8 otherwise (reference: the ``.at[].set``
    scatters of attention.py:719-732, :990-993, :1052-1055)."""
    rows, w_page, w_off = write
    k, v = k[rows], v[rows]
    if "k_scale" not in cache:
        cache["k"][w_page, w_off] = k
        cache["v"][w_page, w_off] = v
        return
    if cache["k"].dtype == torch.uint8:
        (kq, ks), (vq, vs) = quantize_token_int4(k), quantize_token_int4(v)
        kq, vq = pack_int4(kq), pack_int4(vq)
    else:
        (kq, ks), (vq, vs) = quantize_token(k), quantize_token(v)
    cache["k"][w_page, w_off] = kq
    cache["k_scale"][w_page, w_off] = ks
    cache["v"][w_page, w_off] = vq
    cache["v_scale"][w_page, w_off] = vs


# ---------------------------------------------------------------------------
# whole-prompt prefill
# ---------------------------------------------------------------------------

def _dense_attention(q, k, v, positions, kv_positions, window, softcap,
                     pad_mask=None):
    """Masked attention (the reference's ``_dense_attention``,
    src/repro/models/attention.py:103).  q: [B,Tq,H,D], k/v: [B,Tk,Hkv,D],
    positions [B,Tq] and kv_positions [B,Tk]; causal, windowed when
    ``window`` > 0, keys outside ``pad_mask`` [B,Tk] masked.  Scores and
    softmax in f32, P.V with p in v's dtype; returns [B,Tq,H,D] in q's
    dtype."""
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Tq, Hkv, G, D).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    scores = _maybe_softcap(scores, softcap)
    pq = positions[:, :, None]                                   # [B,Tq,1]
    pk = kv_positions[:, None, :]                                # [B,1,Tk]
    w = int(window) if int(window) > 0 else _INT32_MAX
    valid = (pk <= pq) & ((pq - pk) < w)
    if pad_mask is not None:
        valid = valid & pad_mask[:, None, :]
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Tq, H, D).to(q.dtype)


def attn_prefill(params, x, positions, *, n_heads, n_kv_heads, d_head,
                 theta, window, softcap=0.0, qk_norm=False,
                 dense_threshold: int = 2048, pad_mask=None):
    """Full-sequence attention over ``positions`` [B,T] (contiguous from 0,
    as the whole-prompt forward gives them).  Returns (out [B,T,d_model],
    (k, v)) — k/v [B,T,Hkv,D] for the arena.

    Dispatch, as the reference's (src/repro/models/attention.py:226): up
    to ``dense_threshold`` tokens, dense masked attention; above it, the
    flash-attention kernel (plain version on the CPU), which masks by
    absolute index.  Softcap or a ``pad_mask`` above the threshold need the
    reference's blockwise path, which is not ported."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head,
                           positions, theta, qk_norm)
    if T <= dense_threshold:
        out = _dense_attention(q, k, v, positions, positions, window, softcap,
                               pad_mask=pad_mask)
    elif (softcap and softcap > 0.0) or pad_mask is not None:
        raise NotImplementedError(
            "attn_prefill above dense_threshold with softcap or pad_mask "
            "(the blockwise path): ROADMAP queue A, item 11")
    else:
        out = _kops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True,
            window=int(window)).transpose(1, 2)
    out = matmul(out.reshape(B, T, n_heads * d_head), params["wo"])
    return out, (k, v)


# ---------------------------------------------------------------------------
# packed chunked prefill (flat token stream, per-token segment metadata)
# ---------------------------------------------------------------------------

class PackedSegs(NamedTuple):
    """Per-token segment metadata for a packed prefill stream of T tokens
    holding N segments (one per request chunk; pad segments carry
    start == T so no token maps onto them).

    Per-token ([T]): seg_id, positions (absolute), valid (non-pad),
    jj (index within segment), lens_tok (segment length broadcast),
    tok_slot (arena slot broadcast).  Per-segment ([N]): starts, offsets,
    lengths, slots.  Index tensors are int64.
    """
    seg_id: Any
    positions: Any
    valid: Any
    jj: Any
    lens_tok: Any
    tok_slot: Any
    starts: Any
    offsets: Any
    lengths: Any
    slots: Any


def make_packed_segs(starts, offsets, lengths, slots, T: int) -> PackedSegs:
    """Expand per-segment (starts/offsets/lengths/slots, all [N]) into the
    per-token view over a T-token stream.  ``starts`` must be non-decreasing
    with starts[0] == 0; pad segments use start == T (stream length) so the
    running count assigns tail tokens to the last real segment."""
    starts = torch.as_tensor(starts).long()
    dev = starts.device
    offsets = torch.as_tensor(offsets, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev).long()
    slots = torch.as_tensor(slots, device=dev).long()
    t = torch.arange(T, device=dev)
    seg_id = ((t[:, None] >= starts[None, :]).sum(dim=1) - 1).clamp(min=0)
    jj = t - starts[seg_id]
    lens_tok = lengths[seg_id]
    valid = jj < lens_tok
    positions = offsets[seg_id] + jj
    tok_slot = slots[seg_id]
    return PackedSegs(seg_id, positions, valid, jj, lens_tok, tok_slot,
                      starts, offsets, lengths, slots)


def _gather_history(k_pages, v_pages, bt_rows, offsets, ring: int):
    """Each segment's history through its block-table row bt_rows [N, W]:
    prev_k/prev_v [N, W*P, Hkv, D] and the logical position each slot holds,
    prev_pos [N, W*P] (-1 = invalid), exactly as the reference builds them
    (src/repro/models/attention.py:682-703): ring slot s holds the largest
    position p < off with p % ring == s; slots past the ring span and on
    unallocated (sentinel) pages are invalid."""
    n_pages, P, Hkv, D = k_pages.shape
    N, W = bt_rows.shape
    S = W * P
    bt = bt_rows.long()
    pages = bt.clamp(0, n_pages - 1)
    prev_k = k_pages[pages].reshape(N, S, Hkv, D)
    prev_v = v_pages[pages].reshape(N, S, Hkv, D)
    s_idx = torch.arange(S, device=bt.device)
    offs = offsets.long()
    prev_pos = offs[:, None] - 1 - torch.remainder(
        offs[:, None] - 1 - s_idx[None, :], ring)
    prev_pos = torch.where(s_idx[None, :] < ring, prev_pos, -1)
    prev_pos = torch.where((bt >= n_pages).repeat_interleave(P, dim=1), -1,
                           prev_pos)
    return prev_k, prev_v, prev_pos


def _packed_attention(q, k, v, prev_k, prev_v, prev_pos, seg, *,
                      n_heads, n_kv_heads, d_head, window, softcap):
    """Segment-masked attention over a packed stream (the reference's
    ``_packed_attention_jax``, src/repro/models/attention.py:533).

    q: [T, H, D]; k/v: [T, Hkv, D] (the stream's own projected keys/values);
    prev_k/prev_v: [N, S, Hkv, D] per-SEGMENT history with logical positions
    prev_pos [N, S] (-1 = invalid).  Token t attends over its segment's
    history plus the causally visible same-segment stream tokens.  Returns
    ctx [T, H*D] in f32.

    Computed one segment at a time, so memory stays at one segment's
    [len, H, S + len] scores instead of the reference's [T, H, S + T]; on
    the rows of real segments the arithmetic is the reference's.  Rows of
    pad tokens (don't-care in the reference) are zero.  Masked history V
    rows are zeroed, so an unwritten page cannot inject a non-finite value.
    """
    T = q.shape[0]
    S = prev_k.shape[1]
    Hkv = n_kv_heads
    G = n_heads // Hkv
    w = int(window) if int(window) > 0 else _INT32_MAX
    out = torch.zeros((T, Hkv, G, d_head), dtype=torch.float32,
                      device=q.device)
    starts = seg.starts.tolist()
    lengths = seg.lengths.tolist()
    for n, (st, ln) in enumerate(zip(starts, lengths)):
        if ln <= 0 or st >= T:
            continue
        qn = q[st:st + ln].reshape(ln, Hkv, G, d_head).float()
        pq = seg.positions[st:st + ln]                              # [ln]
        s_hist = torch.einsum("thgd,shd->thgs", qn, prev_k[n].float())
        s_self = torch.einsum("thgd,uhd->thgu", qn, k[st:st + ln].float())
        scores = torch.cat([s_hist, s_self], dim=-1) / math.sqrt(d_head)
        scores = _maybe_softcap(scores, softcap)
        pk = torch.cat([prev_pos[n], pq])                           # [S+ln]
        ok = ((pk[None, :] >= 0) & (pk[None, :] <= pq[:, None])
              & ((pq[:, None] - pk[None, :]) < w))
        scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        hv = torch.where((prev_pos[n] >= 0)[:, None, None], prev_v[n],
                         torch.zeros_like(prev_v[n]))
        ctx = torch.einsum("thgs,shd->thgd",
                           probs[..., :S].to(hv.dtype).float(), hv.float())
        ctx = ctx + torch.einsum("thgu,uhd->thgd",
                                 probs[..., S:].to(v.dtype).float(),
                                 v[st:st + ln].float())
        out[st:st + ln] = ctx
    return out.reshape(T, n_heads * d_head)


def packed_write_index(seg: PackedSegs, bt_rows, ring: int, page_size: int,
                       n_pages: int, n_slots: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tokens, pages, offsets) of the pool writes a packed stream makes:
    only each segment's last ``ring`` tokens (ring discipline — earlier
    positions a later token of the same chunk wraps onto must not be
    written), only real segments, only allocated pages.  The same for every
    layer of a run, so the caller computes it once per forward."""
    keep = (seg.valid & (seg.jj >= seg.lens_tok - ring)
            & (seg.tok_slot >= 0) & (seg.tok_slot < n_slots))
    ridx = seg.positions % ring
    w_page = bt_rows.long()[seg.seg_id, ridx // page_size]
    keep = keep & (w_page >= 0) & (w_page < n_pages)
    toks = torch.nonzero(keep).flatten()
    return toks, w_page[toks], (ridx % page_size)[toks]


def _chunk_packed(params, x, seg: PackedSegs, cache, bt_rows, ring: int,
                  write, *, n_heads, n_kv_heads, d_head, theta, window,
                  softcap, qk_norm):
    """What both packed prefill paths share: project the stream, attend
    each token over its segment's ring history (pool ``cache`` [n_pages,
    P, Hkv, D] through the segments' rows ``bt_rows`` [N, W], ring span
    ``ring``) and its segment's visible stream tokens, then write the
    stream's K/V at ``write``.  The history is read BEFORE the write."""
    _, T, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head,
                           seg.positions[None], theta, qk_norm)
    q, k, v = q[0], k[0], v[0]                                   # [T, ...]
    if "k_scale" in cache:
        k_pages, v_pages = _dequantized_pool(cache, x.dtype)
    else:
        k_pages, v_pages = cache["k"], cache["v"]
    if softcap and softcap > 0.0:
        # no kernel path for softcap (not on the paper's models)
        prev_k, prev_v, prev_pos = _gather_history(k_pages, v_pages, bt_rows,
                                                   seg.offsets, ring)
        ctx = _packed_attention(q, k, v, prev_k, prev_v, prev_pos, seg,
                                n_heads=n_heads, n_kv_heads=n_kv_heads,
                                d_head=d_head, window=window, softcap=softcap)
    else:
        i32 = torch.int32
        ctx = _kops.packed_prefill_attention(
            q, k, v, k_pages, v_pages, bt_rows.to(i32).contiguous(),
            seg.starts.to(i32), seg.offsets.to(i32), seg.lengths.to(i32),
            ring=ring, window=int(window)).reshape(T, n_heads * d_head)
    out = matmul(ctx[None].to(x.dtype), params["wo"])
    _write_pool(cache, write, k, v)
    return out


def attn_chunk_packed_paged(params, x, seg: PackedSegs, cache, block_table,
                            *, n_heads, n_kv_heads, d_head, theta, window,
                            softcap=0.0, qk_norm=False, write=None):
    """Packed-stream chunked prefill writing K/V into the paged pool.

    x: [1, T, d] — one flat stream of N segments described by ``seg``;
    ``cache`` {"k","v"} of [n_pages, P, Hkv, D] (or a quantized pool, see
    the module docstring) addressed via ``block_table`` [B, W].  Each token
    attends over its own segment's history plus the causally visible
    tokens of its segment in the stream; the history is read BEFORE the
    stream's K/V are written (a ring entry the chunk overwrites is still
    needed by the chunk's early queries).  The attention runs in the
    packed-prefill kernel (plain version on the CPU) — over the pool
    dequantized to x's dtype when it is quantized, which is the
    reference's dense attention over dequantized history; a softcapped
    model takes a plain gather path.  ``write`` is the precomputed
    ``packed_write_index`` (computed here when omitted).

    Returns (out [1, T, d_model], cache) — the pool updated in place.
    """
    n_pages, P = cache["k"].shape[0], cache["k"].shape[1]
    B = block_table.shape[0]
    R = _paged_ring(window, n_pages, P)
    bt_rows = block_table[seg.slots.clamp(0, B - 1)]             # [N, W]
    if write is None:
        write = packed_write_index(seg, bt_rows, R, P, n_pages, B)
    out = _chunk_packed(params, x, seg, cache, bt_rows, R, write,
                        n_heads=n_heads, n_kv_heads=n_kv_heads,
                        d_head=d_head, theta=theta, window=window,
                        softcap=softcap, qk_norm=qk_norm)
    return out, cache


def arena_packed_view(seg: PackedSegs, n_slots: int, ring: int):
    """The dense arena [B, R, Hkv, D] as a page pool of B pages of R
    tokens (the reference's view, src/repro/models/attention.py:604-610):
    each segment's block-table row is its slot — the pad segments' slot
    sentinel B is an unallocated page — and the writes a packed stream
    makes into it.  Returns (bt_rows [N, 1] int32, write).  The same for
    every layer of a run."""
    bt_rows = seg.slots[:, None].to(torch.int32)
    return bt_rows, packed_write_index(seg, bt_rows, ring, ring, n_slots,
                                       n_slots)


def attn_chunk_packed(params, x, seg: PackedSegs, cache_k, cache_v, *,
                      n_heads, n_kv_heads, d_head, theta, window,
                      softcap=0.0, qk_norm=False, view=None):
    """Packed-stream chunked prefill against the dense decode arena
    (the reference's ``attn_chunk_packed``, src/repro/models/attention.py:
    581).

    x: [1, T, d] — one flat stream of N segments described by ``seg``;
    cache_k/v: [B, R, Hkv, Dh].  Same contract as
    ``attn_chunk_packed_paged`` over ``arena_packed_view`` (``view``, made
    here when omitted): ring span R, history read before the stream's
    K/V are written, each segment's last R tokens written at ring index
    position % R of its slot.  Returns (out [1, T, d_model], cache_k,
    cache_v) — the arena updated in place."""
    B, R = cache_k.shape[0], cache_k.shape[1]
    bt_rows, write = view if view is not None else arena_packed_view(seg, B,
                                                                     R)
    out = _chunk_packed(params, x, seg, {"k": cache_k, "v": cache_v},
                        bt_rows, R, write, n_heads=n_heads,
                        n_kv_heads=n_kv_heads, d_head=d_head, theta=theta,
                        window=window, softcap=softcap, qk_norm=qk_norm)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# decode (dense arena)
# ---------------------------------------------------------------------------

def arena_write_index(pos, S: int, rows=None):
    """(rows, ring index) of a dense decode step's arena writes: row b
    writes position pos[b] at pos % S; only ``rows`` (default: every row)
    write.  The same for every layer of a run."""
    if rows is None:
        rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, pos[rows] % S


def attn_decode(params, x, cache_k, cache_v, pos, *, n_heads, n_kv_heads,
                d_head, theta, window, softcap=0.0, qk_norm=False,
                extra_mask=None, write=None):
    """One-token decode against the dense arena (the reference's
    ``attn_decode``, src/repro/models/attention.py:836).

    x: [B, 1, d_model]; cache_k/v: [B, S, Hkv, Dh] (a ring of S entries);
    pos: scalar or [B] absolute position of the NEW token.  The new K/V
    are written first, IN PLACE, at ring index pos % S — of the rows of
    ``write`` (an ``arena_write_index``; default every row) only, so an
    idle serving slot's arena rows are never touched — and then every row
    attends over its leading min(pos + 1, S) entries, exactly the
    reference's ``s <= pos | pos >= S`` mask, through the dense
    flash-decode kernel (plain version on the CPU).  Softcap and
    ``extra_mask`` have no kernel path and raise.  Returns (out [B,1,d],
    cache_k, cache_v)."""
    if (softcap and softcap > 0.0) or extra_mask is not None:
        raise NotImplementedError(
            "dense attn_decode with softcap or extra_mask: ROADMAP queue A, "
            "item 11")
    B = x.shape[0]
    S = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device).long().expand(B)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head,
                           pos[:, None], theta, qk_norm)
    rows, idx = write if write is not None else arena_write_index(pos, S)
    cache_k[rows, idx] = k[rows, 0]
    cache_v[rows, idx] = v[rows, 0]
    lengths = torch.clamp(pos + 1, max=S).to(torch.int32)
    ctx = _kops.decode_attention(q.reshape(B, n_heads, d_head), cache_k,
                                 cache_v, lengths)
    ctx = ctx.reshape(B, 1, n_heads * d_head).to(x.dtype)
    return matmul(ctx, params["wo"]), cache_k, cache_v


# ---------------------------------------------------------------------------
# decode (paged pool)
# ---------------------------------------------------------------------------

def paged_write_index(block_table, pos, ring: int, page_size: int,
                      n_pages: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows, pages, offsets) of a decode step's pool writes: row b writes
    position pos[b] at ring index pos % ring through its block-table row;
    rows whose page is the sentinel (inactive slots, pad rows) are dropped.
    The same for every layer of a run."""
    B = block_table.shape[0]
    ridx = pos.long() % ring
    w_page = block_table.long()[torch.arange(B, device=pos.device),
                                ridx // page_size]
    keep = (w_page >= 0) & (w_page < n_pages)
    rows = torch.nonzero(keep).flatten()
    return rows, w_page[rows], (ridx % page_size)[rows]


def _decode_head(params, x, cache, block_table, pos, *, n_heads, n_kv_heads,
                 d_head, theta, window, qk_norm, write):
    """What every paged decode path does first: project the new token of
    each row at ``pos`` [B], write its K/V into the pool (quantized when
    the pool is), and return (q [B, 1, H, D], lengths [B]) with lengths =
    min(pos + 1, R): the ring holds exactly that many leading logical
    entries."""
    B = x.shape[0]
    n_pages, P = cache["k"].shape[0], cache["k"].shape[1]
    R = _paged_ring(window, n_pages, P)
    pos = torch.as_tensor(pos, device=x.device).long().expand(B)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head,
                           pos[:, None], theta, qk_norm)
    if write is None:
        write = paged_write_index(block_table, pos, R, P, n_pages)
    _write_pool(cache, write, k[:, 0], v[:, 0])
    return q, torch.clamp(pos + 1, max=R)


def _valid_entries(block_table, lengths, n_pages: int, page_size: int):
    """[B, W*P] mask of the gathered view: before ``lengths`` and on an
    allocated page."""
    bt = block_table.long()
    S = bt.shape[1] * page_size
    return ((torch.arange(S, device=bt.device)[None, :] < lengths[:, None])
            & ~(bt >= n_pages).repeat_interleave(page_size, dim=1))


def _gathered(pages, block_table, n_pages: int):
    """Pool pages [n_pages, P, ...] gathered per row through the block
    table (sentinels clamp; callers mask them): [B, W*P, ...]."""
    g = pages[block_table.long().clamp(0, n_pages - 1)]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def attn_decode_paged(params, x, cache, block_table, pos, *, n_heads,
                      n_kv_heads, d_head, theta, window, softcap=0.0,
                      qk_norm=False, write=None):
    """One-token decode against the paged pool, through the paged
    flash-decode kernel (plain version on the CPU).

    x: [B, 1, d_model]; cache: {"k","v"} of [n_pages, P, Hkv, Dh];
    block_table: [B, W] int32 (sentinel >= n_pages: unallocated — inactive
    rows carry all-sentinel rows, so their writes drop); pos: [B] absolute
    position of the NEW token.  The new entry is written first, then
    attended.  Returns (out, cache) — the pool updated in place.
    """
    B = x.shape[0]
    k_pages, v_pages = cache["k"], cache["v"]
    n_pages, P = k_pages.shape[0], k_pages.shape[1]
    q, lengths = _decode_head(params, x, cache, block_table, pos,
                              n_heads=n_heads, n_kv_heads=n_kv_heads,
                              d_head=d_head, theta=theta, window=window,
                              qk_norm=qk_norm, write=write)
    if softcap and softcap > 0.0:
        # no kernel path for softcap (not on the paper's models): a dense
        # gathered view and the reference math
        gk = _gathered(k_pages, block_table, n_pages)
        gv = _gathered(v_pages, block_table, n_pages)
        Hkv, G = n_kv_heads, n_heads // n_kv_heads
        qg = q.reshape(B, Hkv, G, d_head).float()
        s = torch.einsum("bhgd,bshd->bhgs", qg, gk.float()) / math.sqrt(d_head)
        s = _maybe_softcap(s, softcap)
        ok = _valid_entries(block_table, lengths, n_pages, P)
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhgs,bshd->bhgd", p.to(gv.dtype).float(),
                           gv.float())
    else:
        ctx = _kops.paged_decode_attention(
            q.reshape(B, n_heads, d_head), k_pages, v_pages,
            block_table.to(torch.int32).contiguous(),
            lengths.to(torch.int32))
    ctx = ctx.reshape(B, 1, n_heads * d_head).to(x.dtype)
    out = matmul(ctx, params["wo"])
    return out, cache


def _q8_sweep(q, ck, cks, cv, cvs, valid, *, n_heads, n_kv_heads, d_head,
              softcap):
    """The s8 x s8 decode attention sweep of the int8 paths (the
    reference's ``_q8_sweep``, src/repro/models/attention.py:743).

    q: [B, 1, H, Dh] float; ck/cv: int8 [B, S, Hkv, Dh] (a block-table
    gather of the pool); cks/cvs: f32 [B, S, Hkv] scales; valid: [B, S].
    Returns ctx f32 [B, Hkv, G, Dh].

      scores[s] = (q_q . k_q[s]) * q_scale * k_scale[s]
      out       = (p'_q . v_q)   * p'_scale          with p' = p * v_scale[s]

    The reference contracts s8 x s8 in int32.  Both sums are sums of
    integers here, held exactly: q.k in f32, whose partial sums stay below
    127^2 * Dh < 2^24 (every integer below 2^24 is an f32); p.v in float64,
    since over S tokens they reach 127^2 * S, past 2^24 beyond ~1000 tokens,
    and float64 holds every integer below 2^53 (PyTorch has no int32
    matrix product on CUDA)."""
    B = q.shape[0]
    Hkv = n_kv_heads
    G = n_heads // Hkv
    q_q, q_s = quantize_token(q.reshape(B, Hkv, G, d_head))
    s_int = torch.einsum("bhgd,bshd->bhgs", q_q.float(), ck.float())
    scores = (s_int * q_s[..., None]
              * cks.permute(0, 2, 1)[:, :, None, :])
    scores = scores / math.sqrt(d_head)
    scores = _maybe_softcap(scores, softcap)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)                      # [B,Hkv,G,S]
    # fold v_scale into p, re-quantize, s8 x s8 P.V
    p_scaled = probs * cvs.permute(0, 2, 1)[:, :, None, :]
    p_q, p_s = quantize_token(p_scaled)                        # scale [B,Hkv,G]
    ctx_int = torch.einsum("bhgs,bshd->bhgd", p_q.double(), cv.double())
    return ctx_int.float() * p_s[..., None]


def attn_decode_q8_paged(params, x, cache, block_table, pos, *, n_heads,
                         n_kv_heads, d_head, theta, window, softcap=0.0,
                         qk_norm=False, write=None):
    """int8 paged decode (the reference's ``attn_decode_q8_paged``,
    src/repro/models/attention.py:965): the HALO-faithful memory format on
    the block pool.

    cache: {"k": int8 [n_pages,P,Hkv,Dh], "k_scale": f32 [n_pages,P,Hkv],
    "v", "v_scale"} — scales ride in a parallel page array under the same
    block table.  The new token is quantized and written, the row's pages
    are gathered, and both contractions run s8 x s8 (``_q8_sweep``).  The
    reference has no kernel here either.  Returns (out, cache) — the pool
    updated in place."""
    B = x.shape[0]
    n_pages, P = cache["k"].shape[0], cache["k"].shape[1]
    q, lengths = _decode_head(params, x, cache, block_table, pos,
                              n_heads=n_heads, n_kv_heads=n_kv_heads,
                              d_head=d_head, theta=theta, window=window,
                              qk_norm=qk_norm, write=write)
    gk = _gathered(cache["k"], block_table, n_pages)               # int8
    gks = _gathered(cache["k_scale"], block_table, n_pages)
    gv = _gathered(cache["v"], block_table, n_pages)
    gvs = _gathered(cache["v_scale"], block_table, n_pages)
    valid = _valid_entries(block_table, lengths, n_pages, P)
    ctx = _q8_sweep(q, gk, gks, gv, gvs, valid, n_heads=n_heads,
                    n_kv_heads=n_kv_heads, d_head=d_head, softcap=softcap)
    ctx = ctx.reshape(B, 1, n_heads * d_head).to(x.dtype)
    return matmul(ctx, params["wo"]), cache


def attn_decode_q4_paged(params, x, cache, block_table, pos, *, n_heads,
                         n_kv_heads, d_head, theta, window, softcap=0.0,
                         qk_norm=False, write=None):
    """Packed-int4 paged decode (the reference's ``attn_decode_q4_paged``,
    src/repro/models/attention.py:1015): quarter-width KV bytes.

    cache: {"k": uint8 [n_pages,P,Hkv,Dh//2] (nibble pairs), "k_scale": f32
    [n_pages,P,Hkv], "v", "v_scale"}.  The new token is quantized to int4
    per kv head, packed and written; the sweep runs in the int4 paged
    flash-decode kernel (plain version on the CPU), which unpacks and
    dequantizes in registers.  A softcapped model takes the reference's
    plain gathered view.  Returns (out, cache) — the pool updated in
    place."""
    B = x.shape[0]
    n_pages, P = cache["k"].shape[0], cache["k"].shape[1]
    q, lengths = _decode_head(params, x, cache, block_table, pos,
                              n_heads=n_heads, n_kv_heads=n_kv_heads,
                              d_head=d_head, theta=theta, window=window,
                              qk_norm=qk_norm, write=write)
    if softcap and softcap > 0.0:
        gk = dequantize(unpack_int4(_gathered(cache["k"], block_table,
                                              n_pages)),
                        _gathered(cache["k_scale"], block_table, n_pages))
        gv = dequantize(unpack_int4(_gathered(cache["v"], block_table,
                                              n_pages)),
                        _gathered(cache["v_scale"], block_table, n_pages))
        Hkv, G = n_kv_heads, n_heads // n_kv_heads
        qg = q.reshape(B, Hkv, G, d_head).float()
        s = torch.einsum("bhgd,bshd->bhgs", qg,
                         gk.to(q.dtype).float()) / math.sqrt(d_head)
        s = _maybe_softcap(s, softcap)
        ok = _valid_entries(block_table, lengths, n_pages, P)
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhgs,bshd->bhgd", p, gv)
    else:
        ctx = _kops.paged_decode_attention_q4(
            q.reshape(B, n_heads, d_head), cache["k"], cache["k_scale"],
            cache["v"], cache["v_scale"],
            block_table.to(torch.int32).contiguous(),
            lengths.to(torch.int32))
    ctx = ctx.reshape(B, 1, n_heads * d_head).to(x.dtype)
    return matmul(ctx, params["wo"]), cache
