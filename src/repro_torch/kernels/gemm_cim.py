"""Prefill-shaped matrix product on the card: the wrapper of
``csrc/gemm_cim.cu``.

Replaces the Pallas ``matmul`` (src/repro/kernels/gemm_cim.py:39), the TPU
stand-in for HALO's CiM prefill GEMM: x [M,K] @ w [K,N], f32 accumulation,
result in x's dtype.  The reference's block sizes (``bm``, ``bn``, ``bk``)
are kept as its contract — clipped to the dims, and a dim they do not
divide is refused — but the kernel picks its own tiles and masks its edges.
The source file states what bounds the kernel and how its tiling maps
HALO's weight-stationary dataflow; ``kernels/ref.py`` holds the plain
PyTorch version the CPU path and the card's checks use.

Two routes behind the one C entry point, and ``route`` alone chooses: bf16
that TMA can address (K and N multiples of 8, 16-byte aligned x and w) runs
on the tensor cores (wgmma, TMA-fed ring, a persistent grid); f32 (no IEEE
tensor-core mode) and any other bf16 shape on the ``mma.sync`` / CUDA-core
tile.  The wrapper passes its choice, and for the tensor cores the output
tile's width (``block_n``), to C, which launches that route or refuses
inputs it cannot take.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# route -> the route code of csrc/common.cuh
ROUTE_CODES = {"tile": 0, "wgmma": 1}
_BM = 128             # output rows of a tensor-core tile


def check_blocks(x, w, bm: int, bn: int, bk: int):
    """The reference's contract (gemm_cim.py:42-46): x [M,K] and w [K,N]
    share K; each block size is clipped to its dim and must divide it.
    Returns the clipped (bm, bn, bk); raises ``ValueError`` where the
    reference asserts."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if min(M, K, N) <= 0:
        raise ValueError(f"matmul: empty dims M={M} K={K} N={N}")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if bm <= 0 or bn <= 0 or bk <= 0 or M % bm or N % bn or K % bk:
        raise ValueError(f"matmul: blocks ({bm}, {bn}, {bk}) do not divide "
                         f"(M, N, K) = ({M}, {N}, {K})")
    return bm, bn, bk


def route(dtype: torch.dtype, K: int, N: int, aligned: bool = True) -> str:
    """"wgmma" (tensor cores) for bf16 whose rows TMA can address — K and
    N multiples of 8 and 16-byte aligned bases — else "tile"."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned:
        return "wgmma"
    return "tile"


def block_n(M: int, N: int, sms: int) -> int:
    """The tensor-core route's output tile width: 256 columns, or 128 where
    128 x 256 tiles would be fewer than the SMs (N = 1024 at M = 2048
    gives 64 of them for 132 SMs)."""
    tiles = -(-M // _BM) * -(-N // 256)
    return 256 if tiles >= sms else 128


def matmul(x, w, *, bm: int = 256, bn: int = 256, bk: int = 512):
    """x [M,K] @ w [K,N], both f32 or both bf16, f32 accumulation, result
    [M,N] in x's dtype.

    CUDA tensors only: anything the kernel does not take raises."""
    name = "gemm_cim"
    if x.device.type != "cuda":
        raise ValueError(f"matmul: the kernel runs on CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"matmul: unsupported dtype {x.dtype}")
    check_blocks(x, w, bm, bn, bk)
    _build.check_tensors(name, [x, w], x.dtype, x.device)
    M, K = x.shape
    N = w.shape[1]
    path = route(x.dtype, K, N, _build.aligned16(x, w))
    width = 0
    if path == "wgmma":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        width = block_n(M, N, sms)
    fn = _build.function(name)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = fn(_build.DTYPE_CODES[x.dtype], ROUTE_CODES[path], width,
             x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_cuda(name, err)
    matmul.launches += 1
    matmul.routes[path] += 1
    return out


# launches of the kernel (the wrapper counts each, and nothing else does),
# in all and by route
matmul.launches = 0
matmul.routes = {"wgmma": 0, "tile": 0}
