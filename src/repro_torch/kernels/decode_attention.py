"""Paged flash-decode on the card: the wrapper of
``csrc/paged_decode_attention.cu``.

Replaces the Pallas ``paged_decode_attention``
(src/repro/kernels/decode_attention.py:186).  The source file states what
bounds the kernel and how its layout answers that; ``kernels/ref.py`` holds
the plain PyTorch version the CPU path and the card's checks use.
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
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    B, H, D = q.shape
    n_pages, P, Hkv, Dk = k_pages.shape
    if (v_pages.shape != k_pages.shape or Dk != D or H % Hkv
            or D not in _HEAD_DIMS):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)} "
                         f"(head dim one of {_HEAD_DIMS})")
    W = block_tables.shape[1]
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} "
                         f"/ lengths {tuple(lengths.shape)} for batch {B}")
    _build.check_tensors(name, [q, k_pages, v_pages], q.dtype, q.device)
    _build.check_tensors(name, [block_tables, lengths], torch.int32, q.device)
    fn = _build.function(name)
    out = torch.empty_like(q)
    n_split = -(-W * P // _SPLIT)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, Hkv, n_split, H // Hkv, D), **f32)
    part_ml = torch.empty((B, Hkv, n_split, H // Hkv, 2), **f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, H,
             Hkv, D, n_pages, P, W, _SPLIT, n_split, 1.0 / math.sqrt(D),
             stream)
    _build.check_cuda(name, err)
    paged_decode_attention.launches += 1
    return out


# launches of the kernel (the wrapper counts each, and nothing else does)
paged_decode_attention.launches = 0
