"""Prefill attention on the card: the wrappers of
``csrc/flash_attention.cu`` (whole-prompt flash attention) and
``csrc/packed_prefill_attention.cu`` (the packed multi-request stream).

They replace the Pallas ``flash_attention`` and ``packed_prefill_attention``
(src/repro/kernels/flash_attention.py:83, :217).  Unlike the Pallas
kernels, neither needs a length that is a multiple of its tile: the flash
kernel masks a ragged last tile, and the packed kernel tiles per segment,
so it serves streams whose segments are aligned to any ``pack_align`` (the
serving default is 8).  ``kernels/ref.py`` holds the plain PyTorch
versions.

Each kernel has two routes behind its one C entry point, and ``route``
alone chooses between them: bf16 at head dim 64 or 128 — every full-width
main path — and, for the flash kernel, 160 (zamba2's shared attention
block) runs on the tensor cores (wgmma, K/V staged by TMA,
``csrc/flash_wgmma.cuh``); f32 at any head dim, bf16 at 16, and the packed
kernel over pages of a size that is no multiple of 8, run on the CUDA cores
(``csrc/flash_tile.cuh``).  The wrapper passes its choice to the C entry
point, which launches that route or refuses inputs it cannot take, so the
per-route counts are of the kernels launched.  TMA needs 16-byte aligned
tensors, so the tensor-core route refuses any other (``ValueError``) rather
than falling back.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

# (token, head) query rows per block of both kernels: G = H / Hkv must
# divide it
_ROWS = 64
# head dims the flash kernel is instantiated for: the reduced (16) and full
# (128) configurations, zamba2's shared attention block (160), and the
# benchmark runner's kernel rows (64)
_HEAD_DIMS = (16, 64, 128, 160)
# the packed-prefill kernel's: no model with head dim 160 chunks its prefill
_PACKED_HEAD_DIMS = (16, 64, 128)
# the head dims of the tensor-core route, in bf16
_TENSOR_CORE_DIMS = (64, 128, 160)
# the alignment TMA needs of a tensor's base address, in bytes
ALIGN = 16
# route -> the route code of csrc/common.cuh
ROUTE_CODES = {"tile": 0, "wgmma": 1}


def route(dtype: torch.dtype, head_dim: int, page_size: int = 8) -> str:
    """The route the C entry points take for inputs of ``dtype`` at head
    dim ``head_dim`` (and, for the packed kernel, pool pages of
    ``page_size`` tokens): "wgmma" (tensor cores) for bf16 at 64, 128 or
    160 over pages that are a multiple of 8 tokens (the route stages a page in
    TMA boxes of at least 8 rows), else "tile" (CUDA cores)."""
    if (dtype == torch.bfloat16 and head_dim in _TENSOR_CORE_DIMS
            and page_size % 8 == 0):
        return "wgmma"
    return "tile"


def misaligned(address: int) -> bool:
    """Whether a base address breaks the tensor-core route's TMA rule."""
    return address % ALIGN != 0


def check_aligned(name, tensors) -> None:
    """Refuse (``ValueError``) a tensor the tensor-core route cannot stage."""
    for i, t in enumerate(tensors):
        if misaligned(t.data_ptr()):
            raise ValueError(f"{name}: argument {i} is not {ALIGN}-byte "
                             f"aligned (data_ptr {t.data_ptr():#x}); the "
                             f"tensor-core route stages it by TMA")


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q [B,H,T,D]; k/v [B,Hkv,T,D] (GQA: query head h*G + g reads kv head
    h).  Causal (and, with ``window`` > 0, sliding-window) attention with
    scale 1/sqrt(D).  Returns [B,H,T,D] in q's dtype.

    CUDA tensors only: anything the kernel does not take raises."""
    name = "flash_attention"
    _check_query(name, q)
    B, H, T, D = q.shape
    if (k.shape[0] != B or k.shape[2:] != (T, D) or v.shape != k.shape
            or H % k.shape[1] or _ROWS % (H // k.shape[1])
            or D not in _HEAD_DIMS):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)} (H/Hkv must divide {_ROWS}, head dim one of "
            f"{_HEAD_DIMS})")
    _build.check_tensors(name, [q, k, v], q.dtype, q.device)
    path = route(q.dtype, D)
    if path == "wgmma":
        check_aligned(name, [q, k, v])
    fn = _build.function(name)
    out = torch.empty_like(q)
    err = fn(_build.DTYPE_CODES[q.dtype], ROUTE_CODES[path], q.data_ptr(),
             k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, k.shape[1], D,
             int(bool(causal)), int(window), 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_cuda(name, err)
    flash_attention.launches += 1
    flash_attention.routes[path] += 1
    return out


def packed_prefill_attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                             seg_starts, seg_offsets, seg_lengths, *,
                             ring: int, window: int = 0):
    """q [T,H,D]; k_new/v_new [T,Hkv,D] the stream's own keys/values;
    k_pages/v_pages [n_pages,P,Hkv,D] the history pool; block_tables [N,W]
    int32 per-segment page rows; seg_starts/seg_offsets/seg_lengths [N]
    int32.  ``ring`` is the run's logical ring span, ``window`` its sliding
    window (0 = full).  Returns ctx [T,H,D] in q's dtype; rows outside
    every real segment are zero.

    CUDA tensors only: anything the kernel does not take raises."""
    name = "packed_prefill_attention"
    _check_query(name, q)
    T, H, D = q.shape
    n_pages, P, Hkv, Dk = k_pages.shape
    if (k_new.shape != (T, Hkv, D) or v_new.shape != k_new.shape
            or v_pages.shape != k_pages.shape or Dk != D or H % Hkv
            or _ROWS % (H // Hkv) or D not in _PACKED_HEAD_DIMS):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)} k_new {tuple(k_new.shape)} "
            f"pages {tuple(k_pages.shape)} (H/Hkv must divide {_ROWS}, head "
            f"dim one of {_PACKED_HEAD_DIMS})")
    N, W = block_tables.shape
    for t in (seg_starts, seg_offsets, seg_lengths):
        if t.shape != (N,):
            raise ValueError(f"{name}: segment vectors must be [{N}], got "
                             f"{tuple(t.shape)}")
    if ring < 1:
        raise ValueError(f"{name}: ring must be >= 1, got {ring}")
    _build.check_tensors(name, [q, k_new, v_new, k_pages, v_pages], q.dtype,
                         q.device)
    _build.check_tensors(name, [block_tables, seg_starts, seg_offsets,
                                seg_lengths], torch.int32, q.device)
    path = route(q.dtype, D, P)
    if path == "wgmma":
        check_aligned(name, [q, k_new, v_new, k_pages, v_pages])
    fn = _build.function(name)
    out = torch.zeros_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(_build.DTYPE_CODES[q.dtype], ROUTE_CODES[path], q.data_ptr(),
             k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(),
             block_tables.data_ptr(), seg_starts.data_ptr(),
             seg_offsets.data_ptr(), seg_lengths.data_ptr(), out.data_ptr(),
             T, H, Hkv, D, N, n_pages, P, W, int(ring), int(window),
             1.0 / math.sqrt(D), stream)
    _build.check_cuda(name, err)
    packed_prefill_attention.launches += 1
    packed_prefill_attention.routes[path] += 1
    return out


def _check_query(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")


# launches of each kernel (the wrapper counts each, and nothing else does),
# in all and by route
flash_attention.launches = 0
packed_prefill_attention.launches = 0
flash_attention.routes = {"wgmma": 0, "tile": 0}
packed_prefill_attention.routes = {"wgmma": 0, "tile": 0}
