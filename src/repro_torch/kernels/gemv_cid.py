"""Decode-shaped matrix product with int8 weights on the card: the wrapper
of ``csrc/gemv_int8.cu``.

Replaces the Pallas ``gemv`` (src/repro/kernels/gemv_cid.py:74), both its
variants: int8 weights with a per-output-channel f32 scale applied to the
f32 accumulator (``_gemv_q_kernel``, HALO's CiD decode datapath) and float
weights without a scale (``_gemv_kernel``).  The source file states what
bounds the kernel and how its layout answers that; ``kernels/ref.py`` holds
the plain PyTorch version the CPU path and the card's checks use.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_W_INT8 = 2           # csrc/gemv_int8.cu's weight dtype code for int8
_THREADS_COLS = 8     # 16-byte column groups per block (kColLanes)
_MAX_CHUNK = 2048     # K rows per block at most (x's chunk in shared memory)
_MIN_CHUNK = 256      # K rows per block at least, where K allows
_WAVE = 2 * 132       # blocks to aim for: two per SM of the H100


def chunking(K: int, N: int, w_itemsize: int):
    """(kc, n_chunks): the K rows per block and the number of K chunks.
    Enough chunks that the column tiles times the chunks fill about two
    blocks per SM, but no chunk shorter than 256 rows (where K allows) and
    none longer than 2048; kc is a multiple of 16 rows (one per row lane)."""
    tiles = -(-N // (_THREADS_COLS * (16 // w_itemsize)))
    want = -(-_WAVE // tiles)
    n = max(-(-K // _MAX_CHUNK), min(want, max(1, K // _MIN_CHUNK)))
    kc = -(-(-(-K // n)) // 16) * 16
    return kc, -(-K // kc)


def gemv(x, w, scale=None):
    """x [M,K] (f32 or bf16) @ w [K,N] (int8 with f32 ``scale`` [N], or in
    x's dtype with no scale), f32 accumulation, result [M,N] in x's dtype.

    CUDA tensors only: anything the kernel does not take raises."""
    name = "gemv_int8"
    if x.device.type != "cuda":
        raise ValueError(f"gemv: the kernel runs on CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"gemv: unsupported dtype {x.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemv: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    _build.check_tensors(name, [x], x.dtype, x.device)
    if w.dtype == torch.int8:
        if scale is None or tuple(scale.shape) != (N,):
            raise ValueError("gemv: int8 weights need a scale of shape "
                             f"({N},)")
        _build.check_tensors(name, [w], torch.int8, x.device)
        _build.check_tensors(name, [scale], torch.float32, x.device)
        w_code = _W_INT8
    else:
        if scale is not None:
            raise ValueError("gemv: a scale goes with int8 weights only")
        _build.check_tensors(name, [w], x.dtype, x.device)
        w_code = _build.DTYPE_CODES[x.dtype]
    fn = _build.function(name)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    kc, n_chunks = chunking(K, N, w.element_size())
    part = torch.empty((n_chunks, M, N), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(_build.DTYPE_CODES[x.dtype], w_code, x.data_ptr(), w.data_ptr(),
             scale.data_ptr() if scale is not None else None, out.data_ptr(),
             part.data_ptr(), M, K, N, kc, n_chunks, stream)
    _build.check_cuda(name, err)
    gemv.launches += 1
    return out


# launches of the kernel (the wrapper counts each, and nothing else does)
gemv.launches = 0
