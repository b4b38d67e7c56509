"""The kernels' public entry points: a dispatcher by device.

Tensors on the CPU go to the plain PyTorch version (``kernels/ref.py``);
tensors on CUDA go to the hand-written Hopper kernel, which builds and
launches or raises — nothing falls back to the plain version or moves a
tensor to the CPU.  This takes the place of the reference's
``_interpret()`` switch (src/repro/kernels/ops.py:20), which ran the
Pallas kernels in interpret mode off the TPU.
"""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm_cim as _gemm
from repro_torch.kernels import gemv_cid as _gemv
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.gemm_cim import check_blocks as _check_blocks


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def matmul(x, w, *, bm: int = 256, bn: int = 256, bk: int = 512):
    """Prefill GEMM (CiM path): x [M,K] @ w [K,N], f32 accumulation, in
    x's dtype.  The reference's block contract holds on every device: each
    block is clipped to its dim and must divide it (``ValueError``), checked
    here for the plain version and by the kernel's wrapper on CUDA."""
    if _on_cpu(x):
        _check_blocks(x, w, bm, bn, bk)
        return _ref.matmul_ref(x, w)
    return _gemm.matmul(x, w, bm=bm, bn=bn, bk=bk)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Whole-prompt prefill attention: q [B,H,T,D], kv [B,Hkv,T,D]."""
    fn = _ref.flash_attention_ref if _on_cpu(q) else _fa.flash_attention
    return fn(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, lengths):
    """Decode attention: q [B,H,D] vs the dense arena [B,S,Hkv,D], the
    leading lengths[b] positions of row b valid."""
    fn = _ref.decode_attention_ref if _on_cpu(q) else _da.decode_attention
    return fn(q, k_cache, v_cache, lengths)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """Paged decode attention: q [B,H,D] vs pool [n_pages,P,Hkv,D] gathered
    through block_tables [B,W] (entries >= n_pages: unallocated)."""
    if _on_cpu(q):
        return _ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                               block_tables, lengths)
    return _da.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                      lengths)


def packed_prefill_attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                             seg_starts, seg_offsets, seg_lengths, *,
                             ring: int, window: int = 0):
    """Packed multi-request prefill attention: flat stream q/k_new/v_new
    [T,H|Hkv,D] of segments, each attending over its own history (pool
    [n_pages,P,Hkv,D] via per-segment block_tables [N,W])."""
    fn = (_ref.packed_prefill_attention_ref if _on_cpu(q)
          else _fa.packed_prefill_attention)
    return fn(q, k_new, v_new, k_pages, v_pages, block_tables, seg_starts,
              seg_offsets, seg_lengths, ring=ring, window=window)


def paged_decode_attention_q4(q, k_pages, k_scales, v_pages, v_scales,
                              block_tables, lengths):
    """Paged decode attention over packed-int4 pages: uint8 nibble pairs
    [n_pages,P,Hkv,D/2] plus f32 scale pages [n_pages,P,Hkv] under the same
    block table; q, p and the dequantized V in f32."""
    fn = (_ref.paged_decode_attention_q4_ref if _on_cpu(q)
          else _da.paged_decode_attention_q4)
    return fn(q, k_pages, k_scales, v_pages, v_scales, block_tables, lengths)


def gemv(x, w, scale=None):
    """Decode-shaped product x [M,K] @ w [K,N] with f32 accumulation: int8
    w with a per-column f32 ``scale`` applied to the accumulator, or float
    w in x's dtype without one.  Result in x's dtype."""
    fn = _ref.gemv_ref if _on_cpu(x) else _gemv.gemv
    return fn(x, w, scale)


def ssd_chunk(x, dt, A, Bm, Cm):
    """Mamba-2 intra-chunk SSD over stacked chunks of one B/C group: x
    [nc,H,Q,P], dt [nc,H,Q], A [H], Bm/Cm [nc,Q,N] -> (y [nc,H,Q,P],
    states [nc,H,N,P]), f32."""
    fn = _ref.ssd_chunk_ref if _on_cpu(x) else _ssd.ssd_chunk
    return fn(x, dt, A, Bm, Cm)
