"""The host side of B1, B4 and B6 (``paged_decode_attention``,
``paged_decode_attention_q4``, ``decode_attention``) on the CPU: the plan
their wrapper hands the kernel (split quantum, ring stages, persistent
grid, scratch shapes) for float caches and for packed int4 pages
(``da.PACKED``) at the serve phases' shapes and at edges, the split rule
the kernel applies to a call's longest sequence, the bound that sizes the
scratch, the scratch kept per device, and that the constants mirror
``csrc/decode_split.cuh``.  The kernels themselves run only on the card
(``chip_smoke.py``)."""

import re

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132


@pytest.mark.parametrize("dtype,D,warp_tokens,quantum,stages", [
    (BF16, 128, 16, 64, 2), (F32, 128, 4, 16, 4),
    (BF16, 16, 64, 256, 2), (F32, 16, 32, 128, 4),
    (da.PACKED, 128, 24, 96, 4), (da.PACKED, 16, 64, 256, 4)])
def test_plan_stages_and_quantum(dtype, D, warp_tokens, quantum, stages):
    """bf16 stages 8 KB a warp (16-token tiles for the tensor cores), f32
    4 KB; packed int4 4 KB of K and V rows of D / 2 bytes and two f32
    scales a token, in whole passes of the lanes that copy them (8 rows a
    pass at D = 128, 32 at 16); at most 64 tokens a chunk; four warps a
    block."""
    p = da.plan(dtype, D, 4, 8, 4, 8192, SMS)
    assert (p.warp_tokens, p.quantum, p.stages) == (warp_tokens, quantum,
                                                    stages)
    row = D // 2 + 4 if dtype == da.PACKED else D * dtype.itemsize
    assert p.stages * p.warp_tokens * 2 * row * 4 <= da._RING_BYTES


@pytest.mark.parametrize("capacity", [8192, 16384])
def test_plan_at_the_serve_phases(capacity):
    """``serve_dense`` (arena S = 8192) and ``serve`` (1024 pages of 16:
    W P = 16384) in bf16 at qwen3-8b's geometry, batch 4: one unit an SM
    as the target, at most 25 splits a sequence, a grid of three blocks an
    SM, and the scratch that follows."""
    p = da.plan(BF16, 128, 4, 8, 4, capacity, SMS)
    assert (p.target, p.n_split_max, p.grid) == (132, 25, 396)
    assert p.acc_shape == (4, 8, 25, 4, 128)
    assert p.ml_shape == (4, 8, 25, 4, 2)
    assert p.counters == 32


@pytest.mark.parametrize("len_max,split", [
    (8001, 512), (8064, 512), (4097, 256), (1901, 128), (1964, 128),
    (1000, 64), (1, 64), (0, 64)])
def test_split_at_the_serve_phases_longest_lengths(len_max, split):
    """The split the kernel takes in bf16 at qwen3-8b's geometry: the
    multiple of 64 nearest to the one that cuts the longest sequence into
    132 units over its 8 kv heads, at least 64."""
    p = da.plan(BF16, 128, 4, 8, 4, 8192, SMS)
    assert da.split_for(p, len_max, 8) == split


@pytest.mark.parametrize("len_max,split", [
    (2028, 96), (1964, 96), (1901, 96), (1000, 96), (4103, 288), (1, 96),
    (0, 96)])
def test_packed_split_at_serve_quantized_longest_lengths(len_max, split):
    """B4's split at qwen3-8b's geometry over ``serve_quantized``'s pool
    (1024 pages of 16): the multiple of its 96-token quantum nearest to the
    one that cuts the longest sequence into 132 units over its 8 kv heads,
    at least 96 — so the longest decoding prompt (1900 + 64 new tokens)
    spreads over every SM."""
    p = da.plan(da.PACKED, 128, 4, 8, 4, 16384, SMS)
    assert da.split_for(p, len_max, 8) == split
    if 1901 <= len_max <= 2028:                # serve_quantized's longest
        n = -(-len_max // split) * 8
        assert SMS <= n <= p.grid


@pytest.mark.parametrize("len_max,units", [(8001, 128), (1964, 128)])
def test_longest_sequence_spreads_over_every_sm(len_max, units):
    """The longest sequence of ``serve_dense`` (~8000 tokens) and of
    ``serve`` (~1964) is cut into about one unit an SM."""
    p = da.plan(BF16, 128, 4, 8, 4, 16384, SMS)
    n = -(-len_max // da.split_for(p, len_max, 8)) * 8
    assert n == units
    assert SMS // 2 <= n <= p.grid


@pytest.mark.parametrize("dtype,D,G,Hkv,capacity", [
    (BF16, 128, 4, 8, 8192), (BF16, 128, 1, 32, 4160),
    (F32, 128, 4, 8, 4160), (F32, 16, 4, 1, 2176), (BF16, 16, 1, 4, 96),
    (BF16, 16, 4, 1, 16384), (da.PACKED, 128, 4, 8, 16384),
    (da.PACKED, 16, 4, 1, 2176), (da.PACKED, 128, 1, 32, 4160)])
def test_no_sequence_has_more_splits_than_the_scratch(dtype, D, G, Hkv,
                                                      capacity):
    """For every longest length up to the capacity the kernel's split cuts
    it into at most ``n_split_max`` splits, which sizes the scratch; the
    bound is reached."""
    p = da.plan(dtype, D, G, Hkv, 4, capacity, SMS)
    worst = max(-(-L // da.split_for(p, L, Hkv))
                for L in range(1, capacity + 1))
    assert worst == p.n_split_max
    assert p.acc_shape == (4, Hkv, p.n_split_max, G, D)


@pytest.mark.parametrize("B,Hkv,capacity,grid", [
    (1, 8, 64, 8), (4, 8, 8192, 396), (1, 1, 100, 2), (64, 32, 4160, 396)])
def test_grid_is_persistent_and_never_larger_than_the_units(B, Hkv, capacity,
                                                            grid):
    """The grid is sized from the capacity and the SM count, never from
    the lengths: at most three blocks an SM, and no more blocks than units
    a call can have."""
    assert da.plan(BF16, 128, 4, Hkv, B, capacity, SMS).grid == grid


def test_scratch_is_allocated_once_and_only_grows():
    """The partials, the (m, l) pairs and the zeroed counters are kept per
    device: a call that needs no more gets the same tensors, one that needs
    more gets larger ones, with every counter zero."""
    dev = torch.device("cpu")
    da._scratch.pop(dev, None)
    small = da.plan(BF16, 128, 4, 8, 1, 512, SMS)
    big = da.plan(BF16, 128, 4, 8, 4, 8192, SMS)
    acc, ml, counters = da.scratch(dev, big)
    assert acc.numel() >= big.n_acc and ml.numel() >= big.n_ml
    assert counters.numel() >= big.counters
    again = da.scratch(dev, small)
    assert all(x is y for x, y in zip(again, (acc, ml, counters)))
    bigger = da.plan(BF16, 128, 4, 8, 16, 8192, SMS)
    grown = da.scratch(dev, bigger)
    assert grown[0] is not acc and grown[2] is not counters
    assert grown[0].numel() >= bigger.n_acc
    assert int(grown[2].abs().sum()) == 0
    da._scratch.pop(dev, None)


def test_constants_mirror_the_c_header():
    """The wrapper's planning constants are ``csrc/decode_split.cuh``'s:
    four warps, 64 KB of rings, bf16 in 2 stages and f32 in 4, at most 64
    tokens a chunk and 512 sequences a call; the split rule rounds to the
    nearest quantum in both."""
    text = (_build.CSRC / "decode_split.cuh").read_text()
    assert int(re.search(r"constexpr int kWarps = (\d+);", text)[1]) \
        == da._WARPS
    assert int(re.search(r"constexpr int kRingBytes = (\d+) \* 1024;",
                         text)[1]) * 1024 == da._RING_BYTES
    assert int(re.search(r"constexpr int kMaxBatch = (\d+);", text)[1]) \
        == da._MAX_BATCH
    assert "kStages = kSize == 2 ? 2 : 4;" in text
    assert f"< {da._MAX_WARP_TOKENS} ?" in text
    assert "(static_cast<long long>(len_max) * Hkv + unit / 2) / unit" in text
    # packed int4 pages: Q4Geom's stages, pieces and tokens a stage
    q4 = text[text.index("struct Q4Geom {"):]
    assert int(re.search(r"kStages = (\d+);", q4)[1]) == da._PACKED_STAGES
    assert "kPiece = kRowBytes < 16 ? kRowBytes : 16;" in q4
    assert "kFit = kSlotBytes / (2 * kRowBytes + 8);" in q4
    assert (f"kWarpTok = (kFit < {da._MAX_WARP_TOKENS} ? kFit : "
            f"{da._MAX_WARP_TOKENS}) / kRowsPerPass * kRowsPerPass;") in q4


def test_every_group_size_is_instantiated():
    """The kernels are built for the group sizes the wrapper accepts."""
    text = (_build.CSRC / "decode_split.cuh").read_text()
    built = [int(g) for g in re.findall(
        r"case (\d+): return f\.template operator\(\)<T, kD, \d+>\(\);",
        text)]
    assert tuple(built) == da._GROUPS
    assert re.findall(r"case (\d+): return dispatch_g", text) == [
        str(d) for d in da._HEAD_DIMS]
