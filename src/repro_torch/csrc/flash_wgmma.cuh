// The tensor-core online-softmax step shared by the port's prefill
// attention kernels (flash_attention.cu, packed_prefill_attention.cu) for
// bf16 at head dim 64 and 128.  f32 (no IEEE tensor-core mode), the
// reduced configurations' head dim 16, and pool pages of a size that is no
// multiple of 8 take flash_tile.cuh instead.
//
// What bounds both kernels once the prompt is long: operations, 4 D flops
// per visible (query row, key) pair.  The CUDA-core tile runs every product
// on FMAs (67 TFLOP/s f32 at most); here both products run on wgmma, bf16 in
// and f32 out (989 TFLOP/s), and the K/V traffic is taken off the threads.
//
// A block is one producer warp and two consumer warpgroups.  Each consumer
// owns 64 query rows, wgmma's M: BQ = 64 / G tokens x the G query heads of
// one GQA group against one kv head (row r = head r / BQ, token r % BQ), so
// a block holds 2 BQ tokens and each staged K/V tile serves 128 rows.  The
// producer walks the block's key tiles of 64 keys and fills a ring of
// kStages stages in shared memory by TMA (cp.async.bulk.tensor, 128-byte
// swizzle), each stage with a `full` mbarrier (32 producer arrivals + the
// TMA bytes) and an `empty` one (one arrival per consumer warp).  For each
// tile it also writes the 64 keys' positions (-1 = invalid) and whether
// every key is visible to every query of the block; only tiles where that
// is false (the causal diagonal, the window edge, ragged ends, sentinel
// pages) pay for per-element masking.
//
// Consumer, per tile:
//   S = Q K^T   wgmma m64n64k16, Q and K both K-major in shared memory;
//               bf16 x bf16 products are exact in f32, so the scores
//               differ from the CUDA-core tile's only in summation order.
//   softmax     on the accumulator fragments in registers: masked scores
//               are excluded (p = 0), row max and sum over the 4 lanes of a
//               quad by shuffles, exp2 of scores pre-scaled by log2 e; l
//               sums the unrounded p, as the tile does.
//   O += P V    wgmma m64nDk16 with P as the A operand straight from the
//               score registers, rounded to bf16 (round_to<bf16>, the
//               reference's p.astype(v.dtype)); V is the B operand in
//               shared memory, MN-major (the transposed form bf16 allows).
// O stays in registers (D / 2 f32 a thread); at the end it is divided by
// max(l, 1e-30) and written to global memory.  Q is loaded once per block
// by the consumer threads with 16-byte loads into the same swizzled layout
// (any G dividing 64, no per-head TMA box), rows past the block's live
// tokens as zeros.
//
// NaN never leaks: a tensor core computes 0 * NaN = NaN, and the pool and
// the dense arena hold NaN in slots not yet written.  Every K/V row of a
// stage whose key is invalid is zero before a wgmma reads it: rows past a
// tensor's end are zero-filled by TMA itself; boxes that are not loaded
// (sentinel pages, slots past the history) are zeroed by the producer with
// plain stores; rows inside a loaded box past a segment's or the history's
// end are zeroed by the producer after that box has landed (it waits on an
// `aux` barrier for that one tile, then publishes the stage).
//
// Measured on an H100 at 700 W (PERF.md): 150 registers a thread at
// D = 128, no spills; B5 at qwen3-8b's 8000-token prompt 1.43 ms (its
// operation bound 0.53 ms, SDPA 0.87 ms; the CUDA-core tile took 28.3 ms).
// The block's shape was chosen by timing others once: a ring of 2 or 4
// stages, and one consumer warpgroup with 2 stages (two blocks an SM), ran
// as fast as this one; one consumer with 3 stages (one block an SM) was
// slower.  What binds is each warpgroup's chain S -> softmax -> P V, each
// product waited for before the next step: the softmax does not overlap
// the tensor cores within a warpgroup, only across the two.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "common.cuh"
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace flash_wgmma {

using namespace hopper;

using bf16 = __nv_bfloat16;

constexpr int kM = 64;                   // rows of a consumer warpgroup
constexpr int kWG = 2;                   // consumer warpgroups per block
constexpr int kRows = kM * kWG;          // query rows per block
constexpr int kBK = 64;                  // keys per staged tile
constexpr int kStages = 3;               // depth of the K/V ring
constexpr int kProducerWarp = 4 * kWG;   // the warp after the consumers
constexpr int kThreads = 128 * kWG + 32;
constexpr int kChunk = 64 * 64;          // bf16 of 64 rows x 128 swizzled bytes
constexpr int kChunkBytes = kChunk * 2;

// the route's head dims: a row of a tile is kD / 64 chunks of 128 bytes
template <int kD>
struct Smem {
  static constexpr int kC = kD / 64;
  bf16 q[kWG][kC][kChunk];
  bf16 k[kStages][kC][kChunk];
  bf16 v[kStages][kC][kChunk];
  int kpos[kStages][kBK];        // key positions of the staged tile, -1 invalid
  int all_visible[kStages];      // 1: every key visible to every query
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t aux;                  // the producer's own wait for a tail tile
};

// dynamic shared memory of one block: the layout plus room to align it to
// the 1024 bytes of a 128-byte swizzle pattern
template <int kD>
inline size_t smem_bytes() {
  return sizeof(Smem<kD>) + 1024;
}

template <int kD>
__device__ __forceinline__ Smem<kD>& smem_of(unsigned char* raw) {
  return *reinterpret_cast<Smem<kD>*>(align1024(raw));
}

// ---------------------------------------------------------------------------
// wgmma with A in registers (P . V); the rest is hopper.cuh's
// ---------------------------------------------------------------------------

#define FW_OUT8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FW_OUT8(0), FW_OUT8(8), FW_OUT8(16), FW_OUT8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) B[16 x 128] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FW_OUT8(0), FW_OUT8(8), FW_OUT8(16), FW_OUT8(24), FW_OUT8(32), FW_OUT8(40),
        FW_OUT8(48), FW_OUT8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FW_OUT8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// ---------------------------------------------------------------------------
// producer: the ring of stages
// ---------------------------------------------------------------------------

struct Ring {
  int stage = 0, phase = 0, aux_phase = 0;

  template <int kD>
  __device__ __forceinline__ void acquire(Smem<kD>& sm) {
    mbar_wait(&sm.empty[stage], phase ^ 1);
  }

  // publish the stage: lane 0 runs issue(bar, stage), which starts TMA
  // loads of `bytes` in all onto bar.  Rows >= zero_lo (when < kBK) lie in
  // a loaded box but hold no valid key: they are zeroed once the box has
  // landed, before the consumers may read the stage.  Every lane has
  // written its share of the stage (positions, zeroed rows) before.
  template <int kD, typename Issue>
  __device__ __forceinline__ void publish(Smem<kD>& sm, int lane, uint32_t bytes, int zero_lo,
                                          Issue issue);
};

// rows [lo, hi) of a stage's K and V tiles, every chunk, set to zero by the
// 32 lanes of the producer warp
template <int kD>
__device__ __forceinline__ void zero_rows(Smem<kD>& sm, int st, int lo, int hi, int lane) {
  constexpr int kC = kD / 64;
  const int n = (hi - lo) * 8 * kC;  // 16-byte pieces per tensor
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int i = lane; i < n; i += 32) {
    const int r = lo + i / (8 * kC), c = (i / 8) % kC, p = i % 8;
    *reinterpret_cast<uint4*>(&sm.k[st][c][r * 64 + p * 8]) = z;
    *reinterpret_cast<uint4*>(&sm.v[st][c][r * 64 + p * 8]) = z;
  }
}

template <int kD, typename Issue>
__device__ __forceinline__ void Ring::publish(Smem<kD>& sm, int lane, uint32_t bytes,
                                              int zero_lo, Issue issue) {
  if (zero_lo >= kBK) {
    fence_proxy_async();
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[stage], bytes);
      issue(&sm.full[stage], stage);
    } else {
      mbar_arrive(&sm.full[stage]);
    }
  } else {
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.aux, bytes);
      issue(&sm.aux, stage);
    }
    mbar_wait(&sm.aux, aux_phase);
    aux_phase ^= 1;
    zero_rows(sm, stage, zero_lo, kBK, lane);
    fence_proxy_async();
    mbar_arrive(&sm.full[stage]);
  }
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// the barriers, by one thread, before the block splits into its roles
template <int kD>
__device__ __forceinline__ void init_barriers(Smem<kD>& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], 4 * kWG);
    }
    mbar_init(&sm.aux, 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// consumer: one warpgroup's 64 rows over the block's n_tiles key tiles
// ---------------------------------------------------------------------------

// offset(r): element offset of row r (0..63) of this warpgroup in q and out
// (the same layout); its token r % BQ is live iff below nq and sits at
// position q_pos0 + r % BQ
template <int kD, typename RowOffset>
__device__ __forceinline__ void consume(Smem<kD>& sm, int wg, int n_tiles,
                                        const bf16* __restrict__ q, bf16* __restrict__ out,
                                        RowOffset offset, int BQ, int nq, int q_pos0,
                                        int window, bool causal, float scale_log2) {
  constexpr int kC = kD / 64;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;

  // Q, once: 16-byte pieces into the 128-byte swizzle (chunk j of row r at
  // j ^ (r % 8)), the rows of dead tokens zero
  for (int p = t; p < kM * kD / 8; p += 128) {
    const int r = p / (kD / 8), pc = p % (kD / 8), c = pc / 8, j = pc % 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r % BQ < nq) x = *reinterpret_cast<const uint4*>(q + offset(r) + pc * 8);
    *reinterpret_cast<uint4*>(&sm.q[wg][c][r * 64 + ((j ^ (r & 7)) * 8)]) = x;
  }
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  // this thread's two rows and their query positions
  const int r0 = (t / 32) * 16 + lane / 4, r1 = r0 + 8;
  const int qp0 = q_pos0 + r0 % BQ, qp1 = q_pos0 + r1 % BQ;
  const bool live0 = r0 % BQ < nq, live1 = r1 % BQ < nq;
  const int c2 = 2 * (lane % 4);  // first of this thread's column pairs

  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const uint64_t qd = desc(&sm.q[wg][0][0], 16, 1024);

  int stage = 0, phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(&sm.full[stage], phase);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t kd = desc(&sm.k[stage][0][0], 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      const uint32_t off = ((ks / 4) * kChunkBytes + (ks % 4) * 32) >> 4;
      wgmma_ss<64, 0, 0>(s, qd + off, kd + off, ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scores -> log2 units; masked ones -inf (p = 0, out of the max)
    const float kNegInfinity = -__int_as_float(0x7f800000);
    const bool all = sm.all_visible[stage] != 0;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 kp = *reinterpret_cast<const int2*>(&sm.kpos[stage][8 * j + c2]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * j + e] * scale_log2, x1 = s[4 * j + 2 + e] * scale_log2;
        if (!all) {
          const int k_pos = e ? kp.y : kp.x;
          if (!(live0 && flash_tile::visible(k_pos, qp0, window, causal))) x0 = kNegInfinity;
          if (!(live1 && flash_tile::visible(k_pos, qp1, window, causal))) x1 = kNegInfinity;
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f(s[4 * j + e] - mn0), p1 = exp2f(s[4 * j + 2 + e] - mn1);
        sum0 += p0;
        sum1 += p1;
        s[4 * j + e] = p0;
        s[4 * j + 2 + e] = p1;
      }
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }

    // P (bf16, the A fragments of the 4 k-steps of 16 keys) times V
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    const uint64_t vd = desc(&sm.v[stage][0][0], kChunkBytes, 1024);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, a[kk], vd + ((kk * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    // the stage is free once every warp of both consumers is done with it
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (live0) {
    bf16* dst = out + offset(r0) + c2;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
  }
  if (live1) {
    bf16* dst = out + offset(r1) + c2;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// A map over a bf16 tensor seen as [n2][n1][kD] with strides s1, s2 (in
// elements) for its two outer dims, read in boxes of 64 x b1 x b2 (one
// 128-byte row of 64 values per (i1, i2)), 128-byte swizzle; boxes past an
// end read as zero.  The base and the strides must be 16-byte aligned.
inline bool make_map(CUtensorMap* map, const void* base, int kD, uint64_t n1, uint64_t n2,
                     uint64_t s1, uint64_t s2, uint32_t b1, uint32_t b2) {
  const uint64_t dims[3] = {static_cast<uint64_t>(kD), n1, n2};
  const uint64_t strides[2] = {s1 * 2, s2 * 2};
  const uint32_t box[3] = {64, b1, b2};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace flash_wgmma
