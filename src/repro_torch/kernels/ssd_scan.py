"""Mamba-2 intra-chunk SSD on the card: the wrapper of ``csrc/ssd_chunk.cu``.

Replaces the Pallas ``ssd_chunk`` (src/repro/kernels/ssd_scan.py:64, body
``_ssd_kernel`` :31).  The source file states what bounds the kernel and
how its tiling answers that; ``kernels/ref.py`` holds the plain PyTorch
version the CPU path and the card's checks use.

The kernel has two routes behind its one C entry point, and ``route``
alone chooses between them: bf16 x, B and C at head dim 64 — mamba2's
prefill — run on the tensor cores (``mma.sync``, each f32 operand split
into three bf16 pieces so the products keep the reference's f32
arithmetic, C B^T shared by two heads, y and the states in one launch);
f32, the head dims 16 and 32, and bf16 inputs the tensor-core route cannot
stage (N no multiple of 8, a base address off 16 bytes) run on the
CUDA-core tile in f32, in two launches.  The wrapper passes its choice to
the C entry point, which launches that route or refuses inputs it cannot
take, so the per-route counts are of the kernels launched.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# head dims (P) the kernel is instantiated for: the reduced config (16), the
# reference's kernel tests (32, 64) and mamba2 (64)
_HEAD_DIMS = (16, 32, 64)
# the longest chunk the kernel takes: the reference's SSD chunk
# (SSMConfig.chunk_size; ssm_prefill uses min(chunk_size, T))
_MAX_Q = 256
# the widest state (N) its shared memory is laid out for
_MAX_N = 256
# the tensor-core route's head dim
_MMA_HEAD_DIM = 64
# route -> the route code of csrc/common.cuh (the tensor-core route takes
# ROUTE_WGMMA's code)
ROUTE_CODES = {"tile": 0, "mma": 1}


def route(dtype: torch.dtype, P: int, N: int, aligned: bool = True) -> str:
    """The route the C entry point takes for x, B and C of ``dtype`` at
    head dim ``P`` and state width ``N``: "mma" (tensor cores) for bf16 at
    P = 64 and N <= 256 a multiple of 8 (B and C rows are staged in 16-byte
    pieces) with 16-byte aligned bases (``aligned``), else "tile" (CUDA
    cores)."""
    if (dtype == torch.bfloat16 and P == _MMA_HEAD_DIM and N <= _MAX_N
            and N % 8 == 0 and aligned):
        return "mma"
    return "tile"


def ssd_chunk(x, dt, A, Bm, Cm):
    """x [nc,H,Q,P] and Bm/Cm [nc,Q,N] in one dtype (f32 or bf16); dt
    [nc,H,Q] and A [H] in f32.  Returns (y [nc,H,Q,P], states [nc,H,N,P]),
    both f32 — the chunk-local output and end state before the inter-chunk
    recurrence.  One call is one call of the C entry point: one launch on
    the tensor cores, the tile's two passes otherwise.

    CUDA tensors only: anything the kernel does not take raises."""
    name = "ssd_chunk"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    nc, H, Q, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (nc, H, Q) or A.shape != (H,)
            or Bm.shape != (nc, Q, N) or Cm.shape != Bm.shape
            or P not in _HEAD_DIMS or not 1 <= Q <= _MAX_Q
            or not 1 <= N <= _MAX_N):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} A {tuple(A.shape)} B "
                         f"{tuple(Bm.shape)} C {tuple(Cm.shape)} (P one of "
                         f"{_HEAD_DIMS}, Q <= {_MAX_Q}, N <= {_MAX_N})")
    _build.check_tensors(name, [x, Bm, Cm], x.dtype, x.device)
    _build.check_tensors(name, [dt, A], torch.float32, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((nc, H, Q, P), **f32)
    states = torch.empty((nc, H, N, P), **f32)
    if nc == 0 or H == 0:
        return y, states
    path = route(x.dtype, P, N, _build.aligned16(x, Bm, Cm))
    fn = _build.function(name)
    err = fn(_build.DTYPE_CODES[x.dtype], ROUTE_CODES[path], x.data_ptr(),
             dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             y.data_ptr(), states.data_ptr(), nc, H, Q, P, N,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_cuda(name, err)
    ssd_chunk.launches += 1
    ssd_chunk.routes[path] += 1
    return y, states


# calls of the kernel (the wrapper counts each, and nothing else does), in
# all and by route
ssd_chunk.launches = 0
ssd_chunk.routes = {"mma": 0, "tile": 0}
