"""Flash-decode on the card: the wrappers of
``csrc/paged_decode_attention.cu`` (float pages),
``csrc/paged_decode_attention_q4.cu`` (packed-int4 pages) and
``csrc/decode_attention.cu`` (the dense per-slot arena).

They replace the Pallas ``paged_decode_attention``,
``paged_decode_attention_q4`` and ``decode_attention``
(src/repro/kernels/decode_attention.py:186, :313, :96). The source files state
what bounds each kernel and how its layout answers that; ``kernels/ref.py``
holds the plain PyTorch versions the CPU path and the card's checks use.

All three (B1, B4, B6) run one walk (``csrc/decode_split.cuh``): a
persistent grid whose blocks take (sequence, kv head, split) units in
turn, each warp streaming its chunks of K/V through a ring of asynchronous
copies, and an in-kernel combine, so a call is one launch.  B4 runs it with
the packed-int4 stage and walk (its rows of D / 2 bytes and their scales,
unpacked and computed in f32 on the CUDA cores).  ``plan`` fixes what the
host decides (the split's quantum, the ring's stages, the grid, the
scratch) from the cache's storage dtype, the shapes, the capacity and the
SM count, never from the lengths; ``split_for`` is the rule by which the
kernel cuts the call's longest sequence on the card.  Their partials and
per-(sequence, kv head) arrival counters live in scratch kept per device
(``scratch``, grown only); the counters are left at zero by every launch,
so the scratch serves one stream at a time.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

# head dims the kernels are instantiated for: the reduced (16) and full
# (128) configurations
_HEAD_DIMS = (16, 128)
# query heads per kv head the kernels are instantiated for (llama2-7b,
# qwen3-8b: full and reduced)
_GROUPS = (1, 4)
# B6 alone also takes zamba2's shared attention block: head dim 160 with
# one query head per kv head (csrc/decode_split.cuh dispatch_dense)
_DENSE_EXTRA = {160: (1,)}
# as csrc/decode_split.cuh has them
_WARPS = 4              # warps a block (kWarps)
_RING_BYTES = 64 << 10  # the warps' rings (kRingBytes)
_MAX_BATCH = 512        # sequences a call (kMaxBatch)
_MAX_WARP_TOKENS = 64   # tokens a chunk at most (one bit each in a mask)
# the storage dtype of packed-int4 pages: its plan is Q4Geom's
PACKED = torch.uint8
_PACKED_STAGES = 4      # Q4Geom::kStages
# units the longest sequence is cut into, per SM, and persistent blocks
# per SM (64 KB of ring each; two are resident, the third starts as one
# finishes)
_UNITS_PER_SM = 1
_BLOCKS_PER_SM = 3


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """What the host fixes for one B1, B4 or B6 call.

    ``quantum``: tokens of one round of the block's warps, kWarps chunks
    of ``warp_tokens`` (bf16: 8 KB of K and V a chunk, at most 64 tokens;
    f32: 4 KB; packed int4: the tokens whose K and V rows and scales fit
    in 4 KB, in whole passes of the lanes that copy them); a split is a
    multiple of it.  ``stages``: chunks a warp keeps in its ring (bf16 2,
    f32 and int4 4; 64 KB of rings a block either way).
    At head dim 160 a bf16 stage holds one 16-token tile (10 KB) and an
    f32 stage one pass of the lanes, 4 tokens (5 KB): 80 KB of rings.
    ``target``: units the longest sequence is cut into, about
    (``split_for``).
    ``n_split_max``: the most splits any sequence of the call can have,
    which sizes the scratch.  ``grid``: persistent blocks, at most as many
    as there can be units, at most ``_BLOCKS_PER_SM`` an SM."""
    warp_tokens: int
    quantum: int
    stages: int
    target: int
    n_split_max: int
    grid: int
    acc_shape: Tuple[int, ...]
    ml_shape: Tuple[int, ...]
    counters: int

    @property
    def n_acc(self) -> int:
        return math.prod(self.acc_shape)

    @property
    def n_ml(self) -> int:
        return math.prod(self.ml_shape)


def ring_geometry(dtype: torch.dtype, D: int) -> Tuple[int, int]:
    """(tokens a chunk, ring stages) of a cache of storage ``dtype`` at head
    dim ``D``: ``Geom`` of csrc/decode_split.cuh for f32 and bf16,
    ``Q4Geom`` for packed int4 (``PACKED``: rows of D / 2 bytes, copied in
    pieces of min(16, D / 2) bytes, and two f32 scales a token)."""
    if dtype == PACKED:
        stages = _PACKED_STAGES
        slot = _RING_BYTES // (_WARPS * stages)
        row = D // 2
        rows_per_pass = 32 // (row // min(16, row))
        fit = min(_MAX_WARP_TOKENS, slot // (2 * row + 8))
        return fit // rows_per_pass * rows_per_pass, stages
    item = dtype.itemsize
    stages = 2 if item == 2 else 4           # Geom::kStages
    pieces = D * item // 16                  # Geom::kPieces
    lane_pieces = next(p for p in range(1, pieces + 1)
                       if pieces % p == 0 and 32 % (pieces // p) == 0)
    rows_per_pass = 32 // (pieces // lane_pieces)
    tile = 16 if item == 2 else rows_per_pass  # Geom::kTile
    row = 2 * D * item                       # Geom::kRow
    slot = max(_RING_BYTES // (_WARPS * stages), tile * row)  # kSlotBytes
    return min(_MAX_WARP_TOKENS, slot // row) // tile * tile, stages


@functools.lru_cache(maxsize=256)
def plan(dtype: torch.dtype, D: int, G: int, Hkv: int, B: int,
         capacity: int, sms: int) -> DecodePlan:
    """The plan of a call over ``B`` sequences of at most ``capacity``
    tokens (the arena's S, or the block table's W * P) on a card of
    ``sms`` SMs, for a cache of storage ``dtype`` (q's for B1 and B6,
    ``PACKED`` for B4).  The split ``split_for`` picks for a longest
    length L is ``quantum`` x max(1, round(L Hkv / (target quantum))), so
    a sequence has at most ceil(3 target / (2 Hkv)) splits (and at most
    ceil(capacity / quantum))."""
    tokens, stages = ring_geometry(dtype, D)
    quantum = _WARPS * tokens
    target = max(1, round(_UNITS_PER_SM * sms))
    n_split_max = max(1, min(-(-3 * target // (2 * Hkv)),
                             -(-capacity // quantum)))
    grid = max(1, min(B * Hkv * n_split_max, _BLOCKS_PER_SM * sms))
    return DecodePlan(tokens, quantum, stages, target, n_split_max,
                      grid, (B, Hkv, n_split_max, G, D),
                      (B, Hkv, n_split_max, G, 2), B * Hkv)


def split_for(p: DecodePlan, len_max: int, Hkv: int) -> int:
    """The split the kernel takes when the call's longest sequence has
    ``len_max`` tokens (``split_for`` of csrc/decode_split.cuh): the
    multiple of the quantum nearest to the one that cuts that sequence
    into ``target`` units over its kv heads, at least one quantum."""
    unit = p.target * p.quantum
    return max(1, (len_max * Hkv + unit // 2) // unit) * p.quantum


# device -> (partials, (m, l) pairs, int32 arrival counters), grown as
# calls need
_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = {}
_sms: Dict[torch.device, int] = {}


def scratch(device: torch.device, p: DecodePlan):
    """The device's (partials, (m, l) pairs, counters) scratch for plan
    ``p``: f32 and zeroed int32, allocated once and only grown."""
    n_acc, n_ml = p.n_acc, p.n_ml
    acc, ml, counters = _scratch.get(device, (None, None, None))
    if acc is None or acc.numel() < n_acc:
        acc = torch.empty(max(n_acc, 1), dtype=torch.float32, device=device)
    if ml is None or ml.numel() < n_ml:
        ml = torch.empty(max(n_ml, 1), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < p.counters:
        counters = torch.zeros(max(p.counters, 1), dtype=torch.int32,
                               device=device)
    _scratch[device] = (acc, ml, counters)
    return acc, ml, counters


def _sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def _walk_call(name, q, k, v, capacity, Hkv, kv_dtype):
    """Checks shared by B1, B4 and B6 (after ``_check_query``): the caches
    of storage ``kv_dtype`` (q's for B1 and B6, ``PACKED`` for B4); then
    their plan, scratch and output."""
    B, H, D = q.shape
    G = H // Hkv
    groups = _DENSE_EXTRA.get(D, _GROUPS)
    if G not in groups or B > _MAX_BATCH:
        raise ValueError(f"{name}: {H} query heads over {Hkv} kv heads "
                         f"(groups of {groups} at head dim {D}), batch {B} "
                         f"(at most {_MAX_BATCH})")
    _build.check_tensors(name, [q], q.dtype, q.device)
    _build.check_tensors(name, [k, v], kv_dtype, q.device)
    if not _build.aligned16(q, k, v):
        raise ValueError(f"{name}: q and the K/V caches must be 16-byte "
                         "aligned")
    p = plan(kv_dtype, D, G, Hkv, B, capacity, _sm_count(q.device))
    return p, scratch(q.device, p), torch.empty_like(q)


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
    W = block_tables.shape[1]
    p, (acc, ml, counters), out = _walk_call(name, q, k_pages, v_pages,
                                             W * P, Hkv, q.dtype)
    fn = _build.function(name)
    err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), acc.data_ptr(), ml.data_ptr(),
             counters.data_ptr(), B, H, Hkv, D, n_pages, P, W, p.quantum,
             p.stages, p.target, p.n_split_max, p.grid, 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
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
    _build.check_tensors(name, [k_scales, v_scales], torch.float32, q.device)
    W = block_tables.shape[1]
    p, (acc, ml, counters), out = _walk_call(name, q, k_pages, v_pages,
                                             W * P, Hkv, PACKED)
    fn = _build.function(name)
    err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
             k_scales.data_ptr(), v_pages.data_ptr(), v_scales.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             acc.data_ptr(), ml.data_ptr(), counters.data_ptr(), B, H, Hkv,
             D, n_pages, P, W, p.quantum, p.stages, p.target, p.n_split_max,
             p.grid, 1.0 / math.sqrt(D),
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
    dims = _HEAD_DIMS + tuple(_DENSE_EXTRA)
    if (v_cache.shape != k_cache.shape or Bc != B or Dk != D or H % Hkv
            or D not in dims):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)} "
                         f"(head dim one of {dims})")
    if lengths.shape != (B,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} for batch "
                         f"{B}")
    _build.check_tensors(name, [lengths], torch.int32, q.device)
    p, (acc, ml, counters), out = _walk_call(name, q, k_cache, v_cache, S,
                                             Hkv, q.dtype)
    fn = _build.function(name)
    err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
             v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             acc.data_ptr(), ml.data_ptr(), counters.data_ptr(), B, H, Hkv,
             D, S, p.quantum, p.stages, p.target, p.n_split_max, p.grid,
             1.0 / math.sqrt(D),
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


# launches of each kernel (the wrapper counts each, and nothing else does)
paged_decode_attention.launches = 0
paged_decode_attention_q4.launches = 0
decode_attention.launches = 0
