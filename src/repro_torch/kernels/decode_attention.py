"""Flash-decode on the card: the wrappers of
``csrc/paged_decode_attention.cu`` (float pages),
``csrc/paged_decode_attention_q4.cu`` (packed-int4 pages) and
``csrc/decode_attention.cu`` (the dense per-slot arena).

They replace the Pallas ``paged_decode_attention``,
``paged_decode_attention_q4`` and ``decode_attention``
(src/repro/kernels/decode_attention.py:186, :313, :96). The source files state
what bounds each kernel and how its layout answers that; ``kernels/ref.py``
holds the plain PyTorch versions the CPU path and the card's checks use.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# tokens of one sequence per block of the first pass (a multiple of the
# kernel's 32-token step): short enough that a low-batch decode still puts
# several blocks on every SM
_SPLIT = 128
# head dims the kernel is instantiated for: the reduced (16) and full (128)
# configurations
_HEAD_DIMS = (16, 128)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths):
    """q [B,H,D]; k_pages/v_pages [n_pages,P,Hkv,D]; block_tables [B,W]
    int32 (entries >= n_pages: unallocated); lengths [B] int32 valid
    logical entries per sequence.  Returns [B,H,D] in q's dtype.

    CUDA tensors only: anything the kernel does not take raises."""
    name = "paged_decode_attention"
    _check_query(name, q)
    B, H, D = q.shape
    n_pages, P, Hkv, Dk = k_pages.shape
    if (v_pages.shape != k_pages.shape or Dk != D or H % Hkv
            or D not in _HEAD_DIMS):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)} "
                         f"(head dim one of {_HEAD_DIMS})")
    _check_tables(name, block_tables, lengths, B, q.device)
    _build.check_tensors(name, [q, k_pages, v_pages], q.dtype, q.device)
    fn = _build.function(name)
    out, part_acc, part_ml, n_split = _outputs(q, Hkv, block_tables.shape[1]
                                               * P)
    err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, H,
             Hkv, D, n_pages, P, block_tables.shape[1], _SPLIT, n_split,
             1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_cuda(name, err)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_q4(q, k_pages, k_scales, v_pages, v_scales,
                              block_tables, lengths):
    """q [B,H,D]; k_pages/v_pages uint8 [n_pages,P,Hkv,D/2] nibble pairs
    (element 2i in the low nibble); k_scales/v_scales f32 [n_pages,P,Hkv];
    block_tables [B,W] int32 (entries >= n_pages: unallocated); lengths [B]
    int32.  Returns [B,H,D] in q's dtype; q, p and the dequantized V stay
    f32 inside.

    CUDA tensors only: anything the kernel does not take raises."""
    name = "paged_decode_attention_q4"
    _check_query(name, q)
    B, H, D = q.shape
    n_pages, P, Hkv, D2 = k_pages.shape
    if (v_pages.shape != k_pages.shape or 2 * D2 != D or H % Hkv
            or D not in _HEAD_DIMS
            or k_scales.shape != (n_pages, P, Hkv)
            or v_scales.shape != k_scales.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"scales {tuple(k_scales.shape)}/"
                         f"{tuple(v_scales.shape)} (head dim one of "
                         f"{_HEAD_DIMS})")
    _check_tables(name, block_tables, lengths, B, q.device)
    _build.check_tensors(name, [q], q.dtype, q.device)
    _build.check_tensors(name, [k_pages, v_pages], torch.uint8, q.device)
    _build.check_tensors(name, [k_scales, v_scales], torch.float32, q.device)
    if k_pages.data_ptr() % 4 or v_pages.data_ptr() % 4:
        raise ValueError(f"{name}: pages must be 4-byte aligned")
    fn = _build.function(name)
    out, part_acc, part_ml, n_split = _outputs(q, Hkv, block_tables.shape[1]
                                               * P)
    err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             k_scales.data_ptr(), v_pages.data_ptr(), v_scales.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             part_acc.data_ptr(), part_ml.data_ptr(), B, H, Hkv, D, n_pages,
             P, block_tables.shape[1], _SPLIT, n_split, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_cuda(name, err)
    paged_decode_attention_q4.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths):
    """q [B,H,D]; k_cache/v_cache [B,S,Hkv,D] the dense arena, one slot per
    row; lengths [B] int32 valid leading positions per row (entries at or
    past a length are never read).  Returns [B,H,D] in q's dtype.

    CUDA tensors only: anything the kernel does not take raises."""
    name = "decode_attention"
    _check_query(name, q)
    B, H, D = q.shape
    Bc, S, Hkv, Dk = k_cache.shape
    if (v_cache.shape != k_cache.shape or Bc != B or Dk != D or H % Hkv
            or D not in _HEAD_DIMS):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)} "
                         f"(head dim one of {_HEAD_DIMS})")
    if lengths.shape != (B,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} for batch "
                         f"{B}")
    _build.check_tensors(name, [q, k_cache, v_cache], q.dtype, q.device)
    _build.check_tensors(name, [lengths], torch.int32, q.device)
    fn = _build.function(name)
    out, part_acc, part_ml, n_split = _outputs(q, Hkv, S)
    err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             part_acc.data_ptr(), part_ml.data_ptr(), B, H, Hkv, D, S, _SPLIT,
             n_split, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_cuda(name, err)
    decode_attention.launches += 1
    return out


def _check_query(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")


def _check_tables(name, block_tables, lengths, B, device):
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} "
                         f"/ lengths {tuple(lengths.shape)} for batch {B}")
    _build.check_tensors(name, [block_tables, lengths], torch.int32, device)


def _outputs(q, Hkv, span):
    """The output and the split-K scratch of the three kernels: partial
    accumulators [B,Hkv,n_split,G,D] and (m, l) pairs, f32."""
    B, H, D = q.shape
    n_split = -(-span // _SPLIT)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, Hkv, n_split, H // Hkv, D), **f32)
    part_ml = torch.empty((B, Hkv, n_split, H // Hkv, 2), **f32)
    return torch.empty_like(q), part_acc, part_ml, n_split


# launches of each kernel (the wrapper counts each, and nothing else does)
paged_decode_attention.launches = 0
paged_decode_attention_q4.launches = 0
decode_attention.launches = 0
