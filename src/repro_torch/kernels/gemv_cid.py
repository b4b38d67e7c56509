"""Decode-shaped matrix product with int8 weights on the card: the wrapper
of ``csrc/gemv_int8.cu``.

Replaces the Pallas ``gemv`` (src/repro/kernels/gemv_cid.py:74), both its
variants: int8 weights with a per-output-channel f32 scale applied to the
f32 accumulator (``_gemv_q_kernel``, HALO's CiD decode datapath) and float
weights without a scale (``_gemv_kernel``).  The source file states what
bounds the kernel and how its layout answers that; ``kernels/ref.py`` holds
the plain PyTorch version the CPU path and the card's checks use.

Two routes behind the one C entry point, and ``route`` alone chooses: bf16
x with at most 32 rows over weights TMA can address runs on the tensor
cores (wgmma over a TMA-fed ring, one launch per call); f32 x and any
other input on the CUDA-core tile (two launches).  Both split K across
blocks (``chunking``) and keep the f32 chunk partials, and the tensor-core
route's per-tile arrival counters, in scratch that is allocated once per
device and only grows (``scratch``): a call allocates nothing but its
output.  The counters are left at zero by every launch, so the scratch
serves one stream at a time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_W_INT8 = 2           # csrc/gemv_int8.cu's weight dtype code for int8
# route -> the route code of csrc/common.cuh
ROUTE_CODES = {"tile": 0, "wgmma": 1}
_THREADS_COLS = 8     # tile: 16-byte column groups per block (kColLanes)
_MAX_CHUNK = 2048     # tile: K rows per block at most (x's chunk in shared memory)
_MIN_CHUNK = 256      # K rows per block at least, where K allows
_WAVE = 2 * 132       # blocks to aim for: two per SM of the H100
_WG_COLS = 128        # tensor cores: output columns per work unit (kBN)
_WG_STEP = 64         # tensor cores: K rows per ring stage (kBK)
_WG_SLOTS = 3 * 132   # tensor cores: blocks in flight, three per SM
_WG_MAX_ROWS = 32     # tensor cores: x rows at most (wgmma's N)


def route(dtype: torch.dtype, M: int, K: int, N: int, w_itemsize: int,
          aligned: bool = True) -> str:
    """"wgmma" (tensor cores) for bf16 x of at most 32 rows whose weight
    rows and x rows TMA can address — N w_itemsize and 2 K multiples of 16
    bytes, 16-byte aligned bases — else "tile"."""
    if (dtype == torch.bfloat16 and M <= _WG_MAX_ROWS and K % 8 == 0
            and N * w_itemsize % 16 == 0 and aligned):
        return "wgmma"
    return "tile"


def chunking(K: int, N: int, w_itemsize: int, path: str = "tile"):
    """(kc, n_chunks): the K rows per chunk and the number of K chunks.

    Tile: enough chunks that the column tiles times the chunks fill about
    two blocks per SM, but no chunk shorter than 256 rows (where K allows)
    and none longer than 2048; kc is a multiple of 16 rows (one per row
    lane).  Tensor cores: the persistent grid of three blocks per SM walks
    (128-column tile, chunk) units, as many as fit those blocks once, so
    that each block streams one long chunk and a tile has few partials; kc
    is a multiple of the ring's 64-row stage and at least 256 rows where K
    allows."""
    if path == "wgmma":
        tiles = -(-N // _WG_COLS)
        steps = -(-K // _WG_STEP)
        want = max(1, _WG_SLOTS // tiles)
        n = max(1, min(want, steps // (_MIN_CHUNK // _WG_STEP)))
        kc = -(-steps // n) * _WG_STEP
        return kc, -(-K // kc)
    tiles = -(-N // (_THREADS_COLS * (16 // w_itemsize)))
    want = -(-_WAVE // tiles)
    n = max(-(-K // _MAX_CHUNK), min(want, max(1, K // _MIN_CHUNK)))
    kc = -(-(-(-K // n)) // 16) * 16
    return kc, -(-K // kc)


# device -> (f32 partials, uint32 arrival counters), grown as calls need
_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(device: torch.device, n_part: int, n_counters: int):
    """The device's (partials, counters) scratch, at least ``n_part`` f32
    and ``n_counters`` zeroed counters, allocated once and only grown."""
    part, counters = _scratch.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 1), dtype=torch.int32,
                               device=device)
    _scratch[device] = (part, counters)
    return part, counters


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
    path = route(x.dtype, M, K, N, w.element_size(), _build.aligned16(x, w))
    kc, n_chunks = chunking(K, N, w.element_size(), path)
    part, counters = scratch(x.device, n_chunks * M * N, -(-N // _WG_COLS))
    fn = _build.function(name)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(_build.DTYPE_CODES[x.dtype], ROUTE_CODES[path], w_code,
             x.data_ptr(), w.data_ptr(),
             scale.data_ptr() if scale is not None else None, out.data_ptr(),
             part.data_ptr(), counters.data_ptr(), M, K, N, kc, n_chunks,
             stream)
    _build.check_cuda(name, err)
    gemv.launches += 1
    gemv.routes[path] += 1
    return out


# launches of the kernel (the wrapper counts each, and nothing else does),
# in all and by route
gemv.launches = 0
gemv.routes = {"wgmma": 0, "tile": 0}
