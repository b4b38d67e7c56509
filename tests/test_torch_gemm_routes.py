"""The two routes of B3 (``gemv``, the int8 decode GEMV) and B8
(``matmul``, the CiM prefill GEMM) on the CPU: which route each wrapper's
``route`` picks for a dtype, shape and alignment, B8's tile width, B3's K
split and scratch, that the route codes are the C header's, and that the
Hopper primitives the tensor-core kernels share live in one header.  The
kernels themselves run only on the card (``chip_smoke.py``)."""

import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gemm_cim, gemv_cid

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,K,N,aligned,want", [
    (BF16, 4096, 12288, True, "wgmma"), (BF16, 4096, 1024, True, "wgmma"),
    (BF16, 4104, 1000, True, "wgmma"),     # partial tiles: TMA zero-fills
    (BF16, 41, 24, True, "tile"),          # K rows of 82 bytes
    (BF16, 4096, 1004, True, "tile"),      # N rows of 2008 bytes
    (BF16, 4096, 4096, False, "tile"),     # a base off 16 bytes
    (F32, 4096, 4096, True, "tile"), (F32, 41, 24, True, "tile")])
def test_matmul_route(dtype, K, N, aligned, want):
    """bf16 that TMA can address takes the tensor cores; f32 (no IEEE
    tensor-core mode) and other bf16 shapes the tile."""
    assert gemm_cim.route(dtype, K, N, aligned) == want


@pytest.mark.parametrize("M,N,want", [
    (2048, 12288, 256), (2048, 4096, 256), (2048, 1024, 128),
    (37, 4096, 128), (100, 1000, 128)])
def test_matmul_block_n(M, N, want):
    """256-column tiles unless they would be fewer than the 132 SMs."""
    assert gemm_cim.block_n(M, N, 132) == want


@pytest.mark.parametrize("dtype,M,K,N,itemsize,aligned,want", [
    (BF16, 4, 4096, 4096, 1, True, "wgmma"),     # serve_quantized's wq
    (BF16, 1, 4096, 1024, 1, True, "wgmma"),
    (BF16, 32, 12288, 4096, 1, True, "wgmma"),
    (BF16, 4, 4096, 11008, 1, True, "wgmma"),
    (BF16, 4, 4096, 1000, 2, True, "wgmma"),     # bf16 rows of 2000 bytes
    (BF16, 4, 4096, 1000, 1, True, "tile"),      # int8 rows of 1000 bytes
    (BF16, 33, 4096, 4096, 1, True, "tile"),     # beyond wgmma's N = 32
    (BF16, 4, 4100, 4096, 1, True, "tile"),      # x rows of 8200 bytes
    (BF16, 4, 4096, 4096, 1, False, "tile"),
    (F32, 4, 4096, 4096, 1, True, "tile"), (F32, 1, 4096, 11008, 4, True,
                                            "tile")])
def test_gemv_route(dtype, M, K, N, itemsize, aligned, want):
    """bf16 x of at most 32 rows over weights TMA can address takes the
    tensor cores; f32 x and every other input the tile."""
    assert gemv_cid.route(dtype, M, K, N, itemsize, aligned) == want


@pytest.mark.parametrize("module", [gemm_cim, gemv_cid])
def test_route_codes_match_the_c_header(module):
    """Each wrapper passes its route to C as the code that
    ``csrc/common.cuh`` gives it (as B5/B2's do,
    ``tests/test_torch_kernels.py``)."""
    text = (_build.CSRC / "common.cuh").read_text()
    m = re.search(r"enum \{ ROUTE_TILE = (\d+), ROUTE_WGMMA = (\d+) \};", text)
    assert module.ROUTE_CODES == {"tile": int(m[1]), "wgmma": int(m[2])}


@pytest.mark.parametrize("fn", [gemm_cim.matmul, gemv_cid.gemv])
def test_wrappers_count_launches_by_route(fn):
    assert set(fn.routes) == {"wgmma", "tile"}
    assert isinstance(fn.launches, int)


def test_gemv_scratch_is_allocated_once_and_only_grows():
    """The partials and the zeroed tile counters are kept per device: a
    call that needs no more gets the same tensors, one that needs more gets
    larger ones, with every counter zero."""
    dev = torch.device("cpu")
    gemv_cid._scratch.pop(dev, None)
    part, counters = gemv_cid.scratch(dev, 1000, 8)
    assert part.numel() >= 1000 and counters.numel() >= 8
    again = gemv_cid.scratch(dev, 500, 4)
    assert again[0] is part and again[1] is counters
    bigger, more = gemv_cid.scratch(dev, 5000, 96)
    assert bigger.numel() >= 5000 and more.numel() >= 96
    assert bigger is not part and more is not counters
    assert int(more.abs().sum()) == 0
    assert gemv_cid.scratch(dev, 5000, 96)[0] is bigger
    gemv_cid._scratch.pop(dev, None)


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (4096, 12288),
                                 (12288, 4096), (11008, 4096), (100, 40)])
def test_gemv_tensor_core_chunks_are_whole_stages(K, N):
    """On the tensor cores a chunk is whole 64-row stages, at least 256 rows
    where K allows, and the chunks cover K once; at the served shapes there
    are at least as many (column tile, chunk) units as 128 blocks."""
    kc, n = gemv_cid.chunking(K, N, 1, "wgmma")
    assert kc % 64 == 0 and (kc >= 256 or kc >= K)
    assert (n - 1) * kc < K <= n * kc
    if K >= 4096:
        assert -(-N // 128) * n >= 128


SHARED = re.compile(
    r"(__device__ __forceinline__ \w+ (mbar_init|mbar_arrive|"
    r"mbar_arrive_expect_tx|mbar_wait|tma_load_2d|tma_load_3d|tma_store_2d|"
    r"desc|wgmma_fence|wgmma_commit|wgmma_wait|fence_proxy_async|bar_sync|"
    r"saddr)\(|inline EncodeTiled encode_tiled\(|inline bool tensor_map\()")


@pytest.mark.parametrize("name", ["flash_wgmma.cuh", "gemm_cim.cu",
                                  "gemv_int8.cu"])
def test_hopper_primitives_live_in_one_header(name):
    """B5/B2's header and B8's and B3's sources include ``hopper.cuh`` and
    define none of its barrier, TMA, descriptor, wgmma or tensor-map
    helpers themselves; the header defines each once."""
    src = (_build.CSRC / name).read_text()
    assert '#include "hopper.cuh"' in src
    assert not SHARED.search(src)
    header = (_build.CSRC / "hopper.cuh").read_text()
    found = [m[0] for m in SHARED.findall(header)]
    assert len(found) == len(set(found)) == 16
