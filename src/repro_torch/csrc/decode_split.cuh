// Split-K flash-decode shared by B6 (decode_attention.cu, the dense arena),
// B1 (paged_decode_attention.cu, the page pool) and B4
// (paged_decode_attention_q4.cu, the page pool in packed int4): one query
// token per sequence against its cached K/V, one launch a call.
//
// What bounds it on the H100: bytes.  A decode step reads every valid K/V
// row of the batch once and does 4 G flops per cached element (G = H / Hkv
// query heads share each kv head): at most 4 flops per bf16 byte, far below
// the ~295 at which the tensor cores would bind.  So the design keeps
// enough bytes in flight and keeps the arithmetic, and the fixed cost of a
// launch, small beside them.
//
// Work.  A sequence of len tokens is cut into splits of `split` tokens, a
// multiple of the block's quantum (kWarps warps x kWarpTok tokens); a unit
// is one (sequence b, kv head h, split z).  The longest sequence of the
// call sets the split (split_for: about `target` units over its kv heads,
// `target` = one per SM), so a long prompt spreads over every SM and a
// short one is not cut finer than the quantum.  The grid is persistent and
// sized on the host from capacity and the SM count; every block reads the
// lengths, builds the same prefix of units per sequence and walks units
// blockIdx.x, + gridDim.x, ...: no block is launched for tokens past a
// length, and none is empty.  A sequence of length 0 has one empty unit,
// whose output is 0 (0 / max(l, 1e-30)).
//
// Loads.  Each warp walks chunks w, w + kWarps, ... of its unit's split,
// kWarpTok tokens each, through its own ring of kStages stages in shared
// memory (a chunk's K rows, then its V rows, in the cache's dtype; 64 KB of
// rings a block).  Each lane copies 16-byte pieces of the chunk's rows with
// cp.async, so one stage is in flight while another is computed (bf16: 2
// stages of 8 KB a warp; f32 and packed int4: 4 of 4 KB, int4 with each
// token's two f32 scales beside its rows); cp.async.wait_group and a warp
// barrier order the copies before the reads.  A token at or past the
// length, or on an unallocated page, is never read from device memory: its
// pieces are zero-filled and its bit in the chunk's mask is 0, so its p is
// 0 and nothing a masked row holds (NaN included) reaches the output.
//
// Arithmetic (the walks below).  bf16 runs on the tensor cores (MmaWalk:
// the chunk's tokens are the rows of S^T = K Q^T and of O^T += V^T P^T, the
// G heads the columns), f32 on the CUDA cores (CoreWalk: lanes share a row,
// xor-shuffles finish each dot product), packed int4 on the CUDA cores in
// f32 (Q4Walk: CoreWalk over 4-byte words of eight codes, unpacked in
// registers, each token's scales applied outside its dot products);
// each keeps q and its share of the accumulators in registers and reads
// each staged element from shared memory once for all G heads.  The
// online-softmax state (m, l) is f32 (scale 1/sqrt(D)), updated once per
// chunk (per 16-token tile on the tensor cores); p is rounded to the value
// dtype before P.V, as the reference does (int4: p stays f32, as the
// reference's q4 kernel keeps it).  At the end of a unit each warp leaves
// its state in shared memory and the block merges the warps in warp order,
// once.
//
// Combine.  A unit whose sequence has one split writes its output.  Else
// it leaves its (m, l) and unnormalised accumulator in f32 scratch and
// counts itself in its (b, h) counter; the block that brings the count to
// the number of splits rescales the partials to their common max, sums
// them in split order (the bits do not depend on which block finished
// first), divides by max(l, 1e-30), writes the output and resets the
// counter to 0 for the next launch (so the scratch serves one stream at a
// time).
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace decode_split {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRingBytes = 64 * 1024;       // the warps' rings: dynamic smem
constexpr int kMaxBatch = 512;              // sequences a call

// how a (T, D) instantiation cuts its ring into stages, chunks into tokens
// and rows over lanes: bf16 in 2 stages of 8 KB a warp (16-token tiles for
// the tensor cores), f32 in 4 of 4 KB; at most 64 tokens a chunk
template <typename T, int kD>
struct Geom {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kStages = kSize == 2 ? 2 : 4;
  static constexpr int kSlotBytes = kRingBytes / (kWarps * kStages);
  static constexpr int kWarpTok =
      kSlotBytes / (2 * kD * kSize) < 64 ? kSlotBytes / (2 * kD * kSize) : 64;
  static constexpr int kHalf = kWarpTok * kD * kSize;  // V's offset in a stage
  static constexpr int kVec = 16 / kSize;              // elements a piece
  static constexpr int kRowLanes = kD / kVec;          // lanes over one row
  static constexpr int kRowsPerPass = 32 / kRowLanes;
  static constexpr int kTokPerLane = kWarpTok / kRowsPerPass;
  static constexpr int kQuantum = kWarps * kWarpTok;   // split granularity
  static_assert(kRowLanes >= 1 && kRowLanes <= 32 && 32 % kRowLanes == 0, "row lanes");
  static_assert(kTokPerLane >= 1 && kTokPerLane * kRowsPerPass == kWarpTok, "chunk");
};

// The same for packed int4 rows (D / 2 bytes: element 2i in the low nibble
// of byte i) with one f32 scale per (token, kv head) a side: 4 stages of
// 4 KB a warp, each holding a chunk's K rows, its V rows, then their K and
// V scales.  A lane copies a piece of min(16, D / 2) bytes of a row (the
// first lane of a row also its two scales), and a chunk is as many tokens
// as fit, in whole passes of the warp's lanes, at most 64.
template <int kD>
struct Q4Geom {
  static constexpr int kStages = 4;
  static constexpr int kSlotBytes = kRingBytes / (kWarps * kStages);
  static constexpr int kRowBytes = kD / 2;                       // a packed row
  static constexpr int kPiece = kRowBytes < 16 ? kRowBytes : 16;  // bytes a copy
  static constexpr int kRowLanes = kRowBytes / kPiece;           // lanes over one row
  static constexpr int kRowsPerPass = 32 / kRowLanes;
  static constexpr int kFit = kSlotBytes / (2 * kRowBytes + 8);   // tokens a stage holds
  static constexpr int kWarpTok = (kFit < 64 ? kFit : 64) / kRowsPerPass * kRowsPerPass;
  static constexpr int kTokPerLane = kWarpTok / kRowsPerPass;
  static constexpr int kQuantum = kWarps * kWarpTok;             // split granularity
  static constexpr int kHalf = kWarpTok * kRowBytes;             // V's offset in a stage
  static constexpr int kScales = 2 * kHalf;                      // K scales, then V's
  static_assert(kRowLanes >= 1 && 32 % kRowLanes == 0 && kRowBytes % kPiece == 0, "lanes");
  static_assert(kTokPerLane >= 1 && kScales % 16 == 0, "chunk");
  static_assert(kScales + 8 * kWarpTok <= kSlotBytes, "a stage fits its slot");
};

// what the wrapper passes (kernels/decode_attention.py plan and scratch)
struct Args {
  const void* q;          // [B, H, D]
  const void* k;          // rows of [*, Hkv, D] (int4: D / 2 bytes): the arena or the pool
  const void* v;
  const int* lengths;     // [B]
  void* out;              // [B, H, D]
  float* part_acc;        // [B, Hkv, n_split_max, G, D]
  float* part_ml;         // [B, Hkv, n_split_max, G, 2]
  unsigned* counters;     // [B, Hkv], zero between launches
  int B, H, Hkv, cap, target, n_split_max;
  float scale;
  const float* k_scale = nullptr;   // packed int4 only: [*, Hkv] f32, rows as k's
  const float* v_scale = nullptr;
};

// The split of a call whose longest sequence has len_max tokens: the
// multiple of `quantum` nearest to the one that cuts that sequence into
// `target` units over its Hkv kv heads, and at least one quantum
// (kernels/decode_attention.py split_for is the same rule).
__device__ __forceinline__ int split_for(int len_max, int Hkv, int target, int quantum) {
  const long long unit = static_cast<long long>(target) * quantum;
  const long long rounds = (static_cast<long long>(len_max) * Hkv + unit / 2) / unit;
  return static_cast<int>(rounds > 1 ? rounds : 1) * quantum;
}

// shared memory the merge and the combine borrow from the ring, in floats
template <int kD, int kG>
__host__ __device__ constexpr int merge_floats() {
  return 3 * kWarps * kG + 2 * kG + kWarps * kG * kD;
}
template <int kD, int kG>
__host__ __device__ constexpr int combine_floats(int n_split) {
  return 2 * n_split * kG + kG + 3 + 4 * (kG * kD / 4 < kThreads ? kThreads : kG * kD / 4);
}

// one staged 16-byte piece: four f32
__device__ __forceinline__ void load4(const unsigned char* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// A lane's copies of token r of a chunk from cache row `row` (a token index,
// -1: not a valid key, zero-filled and never read) of kv head h: its piece
// `part` of the K row and of the V row, placed as walk W places them;
// float and bf16 caches.
template <typename T, int kD, typename W>
__device__ __forceinline__ void copy_rows(unsigned char* st, const Args& a, long long row,
                                          int h, int r, int part) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const size_t off =
      row >= 0 ? (static_cast<size_t>(row) * a.Hkv + h) * kD + part * kVec : 0;
  const int piece = W::at(r, part), n = row >= 0 ? 16 : 0;
  cp_async16(st + piece, static_cast<const T*>(a.k) + off, n);
  cp_async16(st + Geom<T, kD>::kHalf + piece, static_cast<const T*>(a.v) + off, n);
}

// The last unit of (b, h) to finish: the partials of its `used` splits,
// rescaled to their common max and summed in split order, over l.  Loads
// are issued before the sums that need them: each thread's first kBatch
// accumulators together with the (m, l) pairs, then kBatch at a time;
// where G x D / 4 is fewer than the block's threads, kSlices of them split
// the splits into contiguous ranges whose sums are added in range order.
template <typename T, int kD, int kG>
__device__ __noinline__ void combine(const Args& a, int b, int h, int used, float* scratch) {
  constexpr int kQuads = kG * kD / 4;
  constexpr int kSlices = kQuads < kThreads ? kThreads / kQuads : 1;
  constexpr int kBatch = 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* w = scratch;                    // [used][kG] m, then each split's weight
  float* ls = w + used * kG;             // [used][kG] l, then weight x l
  float* L = ls + used * kG;             // [kG] the summed denominator
  float4* part = reinterpret_cast<float4*>(scratch + ((2 * used * kG + kG + 3) & ~3));
  // [kSlices][kQuads] the slices' sums, 16-byte aligned
  const size_t base = (static_cast<size_t>(b) * a.Hkv + h) * a.n_split_max;
  const float4* pa = reinterpret_cast<const float4*>(a.part_acc + base * kG * kD);
  const float2* ml = reinterpret_cast<const float2*>(a.part_ml) + base * kG;
  const int slice = tid / kQuads, e4 = tid % kQuads;
  const bool mine = slice < kSlices;
  const int z_lo = slice * used / kSlices, z_hi = mine ? (slice + 1) * used / kSlices : 0;
  float4 p[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    if (z_lo + j < z_hi) p[j] = __ldcg(pa + static_cast<size_t>(z_lo + j) * kQuads + e4);
  for (int i = tid; i < used * kG; i += kThreads) {
    const float2 v = __ldcg(ml + i);
    w[i] = v.x;
    ls[i] = v.y;
  }
  __syncthreads();
  for (int g = warp; g < kG; g += kWarps) {
    float M = NEG_INF;
    for (int z = lane; z < used; z += 32) M = fmaxf(M, w[z * kG + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    for (int z = lane; z < used; z += 32) {
      const float wz = expf(w[z * kG + g] - M);
      w[z * kG + g] = wz;
      ls[z * kG + g] *= wz;
    }
    __syncwarp();
    if (lane == 0) {
      float s = 0.f;
      for (int z = 0; z < used; ++z) s += ls[z * kG + g];
      L[g] = s;
    }
  }
  __syncthreads();
  // kQuads is at most kThreads for every (D, G) but (128, 8), whose
  // 256 quads take two passes
  for (int q4 = e4; mine && q4 < kQuads; q4 += kThreads) {
    const int g = 4 * q4 / kD;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = z_lo; z0 < z_hi; z0 += kBatch) {
      if (z0 != z_lo || q4 != e4) {
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (z0 + j < z_hi) p[j] = __ldcg(pa + static_cast<size_t>(z0 + j) * kQuads + q4);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (z0 + j < z_hi) {
          const float wz = w[(z0 + j) * kG + g];
          s.x = fmaf(wz, p[j].x, s.x);
          s.y = fmaf(wz, p[j].y, s.y);
          s.z = fmaf(wz, p[j].z, s.z);
          s.w = fmaf(wz, p[j].w, s.w);
        }
    }
    part[slice * kQuads + q4] = s;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.H + h * kG) * kD;
  for (int q4 = tid; q4 < kQuads; q4 += kThreads) {
    float4 s = part[q4];
#pragma unroll
    for (int i = 1; i < kSlices; ++i) {
      const float4 v = part[i * kQuads + q4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float d = fmaxf(L[4 * q4 / kD], 1e-30f);
    out[4 * q4] = from_f32<T>(s.x / d);
    out[4 * q4 + 1] = from_f32<T>(s.y / d);
    out[4 * q4 + 2] = from_f32<T>(s.z / d);
    out[4 * q4 + 3] = from_f32<T>(s.w / d);
  }
}

// ---------------------------------------------------------------------------
// The arithmetic of one warp over its chunks.  A walk keeps q and the
// warp's share of the online-softmax state and accumulators in registers;
// `Gm` is the geometry of its ring, `copy` issues a lane's copies of one
// token of a chunk into its stage, `chunk`
// folds a landed chunk in (bit t of `valid`: token t of the chunk is a
// valid key), `finish` leaves the warp's (m, l) and accumulators per head
// in shared memory for the block's merge.
// ---------------------------------------------------------------------------

// f32 on the CUDA cores: kRowLanes lanes share a row, each lane reads back
// exactly the pieces it copied; xor-shuffles finish each dot product.
template <int kD, int kG>
struct CoreWalk {
  using Gm = Geom<float, kD>;
  static constexpr int kVec = Gm::kVec, kRowLanes = Gm::kRowLanes;
  static constexpr int kRowsPerPass = Gm::kRowsPerPass, kTok = Gm::kTokPerLane;
  float qf[kG][kVec], acc[kG][kVec], m[kG], l[kG];

  __device__ __forceinline__ static int at(int r, int c) { return (r * kRowLanes + c) * 16; }
  __device__ __forceinline__ static void copy(unsigned char* st, const Args& a, long long row,
                                              int h, int r, int part) {
    copy_rows<float, kD, CoreWalk>(st, a, row, h, r, part);
  }

  // q: the first query head of the group
  __device__ __forceinline__ void start(const float* q, int lane) {
    const float* qb = q + (lane % kRowLanes) * kVec;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        qf[g][j] = qb[g * kD + j];
        acc[g][j] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void chunk(const unsigned char* st, uint64_t valid, float scale,
                                        int lane) {
    const int grp = lane / kRowLanes;
    float s[kTok][kG];
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      float kf[kVec];
      load4(st + (lane + 32 * i) * 16, kf);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) d = fmaf(qf[g][j], kf[j], d);
        s[i][g] = d;
      }
    }
#pragma unroll
    for (int i = 0; i < kTok; ++i)
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int o = kRowLanes / 2; o > 0; o >>= 1)
          s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], o);
    // one online-softmax update per head for the chunk's tokens; s becomes
    // p (rounding it to the value dtype, f32, changes nothing)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int i = 0; i < kTok; ++i) {
        s[i][g] *= scale;
        if (valid >> (grp + kRowsPerPass * i) & 1u) m_new = fmaxf(m_new, s[i][g]);
      }
      const float corr = expf(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTok; ++i) {
        const float p = (valid >> (grp + kRowsPerPass * i) & 1u) ? expf(s[i][g] - m_new) : 0.f;
        sum += p;
        s[i][g] = p;
      }
      l[g] = l[g] * corr + sum;
      m[g] = m_new;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[g][j] *= corr;
    }
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      float vf[kVec];
      load4(st + Gm::kHalf + (lane + 32 * i) * 16, vf);
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[g][j] = fmaf(s[i][g], vf[j], acc[g][j]);
    }
  }

  __device__ __forceinline__ void finish(float* xm, float* xl, float* xa, int warp, int lane) {
    // the lane groups merge (xor over the group bits of lane)
#pragma unroll
    for (int o = kRowLanes; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mn = fmaxf(m[g], mo);
        const float c = expf(m[g] - mn), co = expf(mo - mn);
        l[g] = l[g] * c + lo * co;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], o);
          acc[g][j] = acc[g][j] * c + ao * co;
        }
        m[g] = mn;
      }
    }
    if (lane < kRowLanes) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int j = 0; j < kVec; ++j) xa[(warp * kG + g) * kD + lane * kVec + j] = acc[g][j];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        xm[warp * kG + g] = m[g];
        xl[warp * kG + g] = l[g];
      }
    }
  }
};

// bf16 on the tensor cores, with the tokens as the rows of each product:
// S^T = K Q^T by mma.m16n8k16 (A: 16 staged K rows by ldmatrix; B: q's G
// heads as 8 columns, the rest zero) and O^T += V^T P^T by mma.m16n8k16
// (A: the staged V rows by ldmatrix.trans; B: P^T, the bf16-rounded p
// turned from S^T's accumulator layout into an operand by movmatrix).
// Lane l holds heads 2 (l % 4) and 2 (l % 4) + 1 of S^T's rows (tokens)
// l / 4 and l / 4 + 8 and of O^T's rows (head dims), so the online-softmax
// state of a head lives in the eight lanes of one l % 4, and a rescale
// touches only a lane's own accumulators.  Pieces are stored with their
// 16-byte column xor-ed by the row, so the 8 rows an ldmatrix reads fall in
// 8 distinct bank groups.
template <int kD, int kG>
struct MmaWalk {
  static_assert(kG <= 8, "the G heads are the 8 columns of B");
  using Gm = Geom<__nv_bfloat16, kD>;
  static constexpr int kPieces = kD / 8;          // 16-byte pieces a row
  static constexpr int kRowBytes = kD * 2;
  static constexpr int kSteps = kD / 16;          // 16-deep steps of S^T, 16-row tiles of O^T
  static constexpr int kTiles = Gm::kWarpTok / 16;  // 16-token tiles a chunk
  static constexpr int kSw = kPieces < 8 ? kPieces : 8;
  static_assert(kTiles >= 1 && kTiles * 16 == Gm::kWarpTok, "whole 16-token tiles");
  uint32_t qb[kSteps][2];   // B fragments of Q^T: q[2 (l % 4) + {0,1} (+ 8)] of head l / 4
  float o[kSteps][4];       // O^T: dims l / 4 (+ 8) of each 16-dim tile, heads 2 (l % 4) + {0, 1}
  float m[2], l[2];         // heads 2 (l % 4) + {0, 1}; l is this lane's share

  __device__ __forceinline__ static int swz(int r, int c) {
    return c ^ ((r / (8 / kSw)) % kSw);
  }
  __device__ __forceinline__ static int at(int r, int c) { return r * kRowBytes + swz(r, c) * 16; }
  __device__ __forceinline__ static void copy(unsigned char* st, const Args& a, long long row,
                                              int h, int r, int part) {
    copy_rows<__nv_bfloat16, kD, MmaWalk>(st, a, row, h, r, part);
  }

  __device__ __forceinline__ void start(const __nv_bfloat16* q, int lane) {
    const int g = lane >> 2, c = 2 * (lane & 3);
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + g * kD + c);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      qb[s][0] = g < kG ? qw[s * 8] : 0u;
      qb[s][1] = g < kG ? qw[s * 8 + 4] : 0u;
      o[s][0] = o[s][1] = o[s][2] = o[s][3] = 0.f;
    }
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void chunk(const unsigned char* st, uint64_t valid, float scale,
                                        int lane) {
    const int g = lane >> 2;
#pragma unroll
    for (int tile = 0; tile < kTiles; ++tile) {
      const unsigned char* kt = st + tile * 16 * kRowBytes;
      const unsigned char* vt = st + Gm::kHalf + tile * 16 * kRowBytes;
      // S^T: the tile's 16 tokens x 8 heads
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const int r = (lane & 7) + 8 * ((lane >> 3) & 1);  // a0/a2: rows 0-7, a1/a3: 8-15
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          uint32_t a[4];
          ldsm_x4(a, kt + r * kRowBytes + swz(r, 2 * k + (lane >> 4)) * 16);
          mma_16816(s, a, qb[k][0], qb[k][1]);
        }
      }
      const bool v0 = valid >> (tile * 16 + g) & 1u, v1 = valid >> (tile * 16 + g + 8) & 1u;
      uint32_t pb[2];   // P^T as B: tokens 2 (l % 4) + {0, 1} (+ 8) of head l / 4
      float corr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {   // head 2 (l % 4) + j
        const float s0 = s[j] * scale, s1 = s[2 + j] * scale;
        float mx = fmaxf(v0 ? s0 : NEG_INF, v1 ? s1 : NEG_INF);
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float m_new = fmaxf(m[j], mx);
        corr[j] = expf(m[j] - m_new);
        m[j] = m_new;
        const float p0 = v0 ? expf(s0 - m_new) : 0.f, p1 = v1 ? expf(s1 - m_new) : 0.f;
        l[j] = l[j] * corr[j] + (p0 + p1);
        s[j] = p0;
        s[2 + j] = p1;
      }
      pb[0] = movmatrix_t(pack_bf16(s[0], s[1]));   // tokens 0-7, rounded to bf16
      pb[1] = movmatrix_t(pack_bf16(s[2], s[3]));   // tokens 8-15
      // O^T += V^T P^T, 16 head dims at a time
      const int r = (lane & 7) + 8 * (lane >> 4);   // a0/a1: tokens 0-7, a2/a3: 8-15
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        o[k][0] *= corr[0];
        o[k][1] *= corr[1];
        o[k][2] *= corr[0];
        o[k][3] *= corr[1];
        uint32_t a[4];
        ldsm_x4_t(a, vt + r * kRowBytes + swz(r, 2 * k + ((lane >> 3) & 1)) * 16);
        mma_16816(o[k], a, pb[0], pb[1]);
      }
    }
  }

  __device__ __forceinline__ void finish(float* xm, float* xl, float* xa, int warp, int lane) {
    const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) l[j] += __shfl_xor_sync(0xffffffffu, l[j], x);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int h = c + j;
      if (h >= kG) continue;
      float* row = xa + (warp * kG + h) * kD;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        row[16 * k + g] = o[k][j];
        row[16 * k + g + 8] = o[k][2 + j];
      }
      if (g == 0) {
        xm[warp * kG + h] = m[j];
        xl[warp * kG + h] = l[j];
      }
    }
  }
};

// Packed int4 rows on the CUDA cores in f32, q of type T (the reference's
// q4 kernel keeps q, p and the dequantized V in f32).  In the products
// kLanes = D / 8 lanes share a row, each one 4-byte word of eight codes,
// unpacked in registers by the shift pair (element 8 w + e is nibble e of
// word w; a nibble of 8 or more is its value - 16, the shift pair
// sign-extends); xor-shuffles finish each dot product.  The token's scales
// stay outside the inner sums: s = (sk (q . k_codes)) / sqrt(D) and acc +=
// (p sv) v_codes, so a code is widened once and never multiplied by its
// scale.
template <typename T, int kD, int kG>
struct Q4Walk {
  using Gm = Q4Geom<kD>;
  static constexpr int kLanes = kD / 8;          // lanes over one row in the products
  static constexpr int kRows = 32 / kLanes;      // rows a pass
  static constexpr int kPass = Gm::kWarpTok / kRows;
  static_assert(kLanes >= 1 && kLanes <= 32 && kPass * kRows == Gm::kWarpTok, "passes");
  float qf[kG][8], acc[kG][8], m[kG], l[kG];

  __device__ __forceinline__ static void copy(unsigned char* st, const Args& a, long long row,
                                              int h, int r, int part) {
    const bool ok = row >= 0;
    const size_t rh = ok ? static_cast<size_t>(row) * a.Hkv + h : 0;  // (token, kv head)
    const size_t off = rh * Gm::kRowBytes + part * Gm::kPiece;
    const int at = r * Gm::kRowBytes + part * Gm::kPiece;
    cp_async_n<Gm::kPiece>(st + at, static_cast<const unsigned char*>(a.k) + off, ok);
    cp_async_n<Gm::kPiece>(st + Gm::kHalf + at, static_cast<const unsigned char*>(a.v) + off,
                           ok);
    if (part == 0) {
      cp_async_n<4>(st + Gm::kScales + 4 * r, a.k_scale + rh, ok);
      cp_async_n<4>(st + Gm::kScales + 4 * (Gm::kWarpTok + r), a.v_scale + rh, ok);
    }
  }

  // the eight codes of a staged word, in f32
  __device__ __forceinline__ static void unpack(uint32_t w, float (&f)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = static_cast<float>(static_cast<int>(w << (28 - 4 * e)) >> 28);
  }

  // q: the first query head of the group
  __device__ __forceinline__ void start(const T* q, int lane) {
    const T* qb = q + (lane % kLanes) * 8;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qf[g][e] = to_f32(qb[g * kD + e]);
        acc[g][e] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void chunk(const unsigned char* st, uint64_t valid, float scale,
                                        int lane) {
    const int grp = lane / kLanes, word = (lane % kLanes) * 4;
    const float* ks = reinterpret_cast<const float*>(st + Gm::kScales);
    const float* vs = ks + Gm::kWarpTok;
    float s[kPass][kG];
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      float kf[8];
      unpack(*reinterpret_cast<const uint32_t*>(st + (grp + kRows * i) * Gm::kRowBytes + word),
             kf);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
        s[i][g] = d;
      }
    }
#pragma unroll
    for (int i = 0; i < kPass; ++i)
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], o);
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      const float sk = ks[grp + kRows * i];
#pragma unroll
      for (int g = 0; g < kG; ++g) s[i][g] = __fmul_rn(__fmul_rn(s[i][g], sk), scale);
    }
    // one online-softmax update per head for the chunk's tokens; s becomes p
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int i = 0; i < kPass; ++i)
        if (valid >> (grp + kRows * i) & 1u) m_new = fmaxf(m_new, s[i][g]);
      const float corr = expf(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const float p = (valid >> (grp + kRows * i) & 1u) ? expf(s[i][g] - m_new) : 0.f;
        sum += p;
        s[i][g] = p;
      }
      l[g] = l[g] * corr + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < kPass; ++i) {
      float vf[8];
      unpack(*reinterpret_cast<const uint32_t*>(st + Gm::kHalf +
                                                (grp + kRows * i) * Gm::kRowBytes + word),
             vf);
      const float sv = vs[grp + kRows * i];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float ps = __fmul_rn(s[i][g], sv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(ps, vf[e], acc[g][e]);
      }
    }
  }

  __device__ __forceinline__ void finish(float* xm, float* xl, float* xa, int warp, int lane) {
    // the lane groups merge (xor over the group bits of lane)
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mn = fmaxf(m[g], mo);
        const float c = expf(m[g] - mn), co = expf(mo - mn);
        l[g] = l[g] * c + lo * co;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * c + ao * co;
        }
        m[g] = mn;
      }
    }
    if (lane < kLanes) {
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) xa[(warp * kG + g) * kD + lane * 8 + e] = acc[g][e];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        xm[warp * kG + g] = m[g];
        xl[warp * kG + g] = l[g];
      }
    }
  }
};

template <typename T, int kD, int kG>
using Walk =
    std::conditional_t<std::is_same<T, float>::value, CoreWalk<kD, kG>, MmaWalk<kD, kG>>;

// The rows of a page pool (B1, B4): token t of sequence b lives at pool row
// page * P + t % P of its block-table page bt[b, t / P]; a token is a valid
// key iff that entry is allocated (0 <= page < n_pages).  Pages may be in
// any order; the table row is a few L1-resident words.
struct PoolRows {
  const int* bt;  // [B, W]
  int W, P, n_pages;
  __device__ __forceinline__ long long operator()(int b, int t) const {
    const int page = bt[static_cast<size_t>(b) * W + t / P];
    return page >= 0 && page < n_pages ? static_cast<long long>(page) * P + t % P : -1;
  }
};

// The kernel body.  `rows(b, t)` names the cache row (a token index into
// the [rows, Hkv, D] array) that holds token t < len of sequence b, or -1
// when t is not a valid key (an unallocated page).  W is the walk: by
// default the float cache's for q's dtype T, Q4Walk for packed int4 pages.
template <typename T, int kD, int kG, typename Rows, typename W = Walk<T, kD, kG>>
__device__ __forceinline__ void run(const Args& a, const Rows& rows) {
  using Gm = typename W::Gm;
  constexpr int kRowLanes = Gm::kRowLanes;
  constexpr int kRowsPerPass = Gm::kRowsPerPass, kWarpTok = Gm::kWarpTok;
  constexpr int kTok = Gm::kTokPerLane, kStages = Gm::kStages, kSlot = Gm::kSlotBytes;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int s_len[kMaxBatch];                      // lengths, clamped to cap
  __shared__ int s_pre[kMaxBatch + 1];                  // units before sequence b
  __shared__ uint64_t s_valid[kWarps][4];                // a chunk's valid tokens
  __shared__ int s_max[kWarps];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = a.B, Hkv = a.Hkv;

  // the split, from the longest sequence; units per sequence and their prefix
  int mx = 0;
  for (int b = tid; b < B; b += kThreads) {
    s_len[b] = min(max(a.lengths[b], 0), a.cap);
    mx = max(mx, s_len[b]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  int len_max = s_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) len_max = max(len_max, s_max[w]);
  const int split = split_for(len_max, Hkv, a.target, Gm::kQuantum);
  if (warp == 0) {
    if (lane == 0) s_pre[0] = 0;
    int run_sum = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      int x = b < B ? max(1, (s_len[b] + split - 1) / split) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (b < B) s_pre[b + 1] = run_sum + x;
      run_sum += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();

  const int total = s_pre[B] * Hkv;
  const int part = lane % kRowLanes, grp = lane / kRowLanes;
  unsigned char* my_ring = ring + warp * kStages * kSlot;

  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    int lo = 0, hi = B;  // b: the last sequence whose units start at or before u
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_pre[mid] * Hkv <= u) lo = mid; else hi = mid;
    }
    const int b = lo, used = s_pre[b + 1] - s_pre[b];
    const int r = u - s_pre[b] * Hkv, h = r / used, z = r % used;
    const int t_begin = z * split, t_end = min(t_begin + split, s_len[b]);
    const int n_chunks = t_end > t_begin ? (t_end - t_begin + kWarpTok - 1) / kWarpTok : 0;
    const int mine = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps : 0;

    // the warp's k-th chunk into ring stage k % kStages; bit t of the
    // chunk's mask: its token t is a valid key
    auto issue = [&](int k) {
      const int slot = k % kStages;
      unsigned char* st = my_ring + slot * kSlot;
      const int t0 = t_begin + (warp + k * kWarps) * kWarpTok + grp;
      uint64_t valid = 0;
#pragma unroll
      for (int i = 0; i < kTok; ++i) {
        const int t = t0 + kRowsPerPass * i;
        const long long row = t < t_end ? rows(b, t) : -1;
        W::copy(st, a, row, h, grp + kRowsPerPass * i, part);
        const unsigned bal = __ballot_sync(0xffffffffu, row >= 0);
#pragma unroll
        for (int g = 0; g < kRowsPerPass; ++g)
          valid |= static_cast<uint64_t>(bal >> (g * kRowLanes) & 1u) << (g + kRowsPerPass * i);
      }
      if (lane == 0) s_valid[warp][slot] = valid;
    };
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < mine) issue(s);
      cp_async_commit();
    }

    W walk;
    walk.start(static_cast<const T*>(a.q) + (static_cast<size_t>(b) * a.H + h * kG) * kD, lane);

#pragma unroll 1
    for (int k = 0; k < mine; ++k) {
      cp_async_wait<kStages - 1>();  // chunk k has landed (this lane's pieces)
      __syncwarp();                  // and every lane's, with its mask
      const int slot = k % kStages;
      walk.chunk(my_ring + slot * kSlot, s_valid[warp][slot], a.scale, lane);
      __syncwarp();
      if (k + kStages < mine) issue(k + kStages);
      cp_async_commit();
    }

    // then the warps, through shared memory the ring no longer needs
    cp_async_wait<0>();
    __syncthreads();
    float* xm = reinterpret_cast<float*>(ring);  // [kWarps][kG] m
    float* xl = xm + kWarps * kG;                // [kWarps][kG] l
    float* xw = xl + kWarps * kG;                // [kWarps][kG] weights
    float* xM = xw + kWarps * kG;                // [kG] max
    float* xL = xM + kG;                         // [kG] denominator
    float* xa = xL + kG;                         // [kWarps][kG][kD] accumulators
    walk.finish(xm, xl, xa, warp, lane);
    __syncthreads();
    if (tid < kG) {
      float M = xm[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) M = fmaxf(M, xm[w * kG + tid]);
      float L = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float ww = expf(xm[w * kG + tid] - M);
        xw[w * kG + tid] = ww;
        L += ww * xl[w * kG + tid];
      }
      xM[tid] = M;
      xL[tid] = L;
    }
    __syncthreads();
    const size_t unit = (static_cast<size_t>(b) * Hkv + h) * a.n_split_max + z;
    for (int e = tid; e < kG * kD; e += kThreads) {
      const int g = e / kD;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) A = fmaf(xw[w * kG + g], xa[w * kG * kD + e], A);
      if (used == 1)
        static_cast<T*>(a.out)[(static_cast<size_t>(b) * a.H + h * kG) * kD + e] =
            from_f32<T>(A / fmaxf(xL[g], 1e-30f));
      else
        a.part_acc[unit * kG * kD + e] = A;
    }
    if (used > 1) {
      if (tid < kG) {
        a.part_ml[(unit * kG + tid) * 2] = xM[tid];
        a.part_ml[(unit * kG + tid) * 2 + 1] = xL[tid];
      }
      __threadfence();
      __syncthreads();
      if (tid == 0)
        s_last = atomicAdd(&a.counters[b * Hkv + h], 1u) == static_cast<unsigned>(used - 1);
      __syncthreads();
      if (s_last) {
        __threadfence();
        combine<T, kD, kG>(a, b, h, used, reinterpret_cast<float*>(ring));
        if (tid == 0) a.counters[b * Hkv + h] = 0u;
      }
    }
    __syncthreads();  // the next unit's loads overwrite what was read here
  }
}

// Refuses what the kernels were not built for: the plan's quantum and
// stages must be this build's (of the ring geometry Gm), the batch at most
// kMaxBatch, the merge and the combine must fit in the ring.
template <typename T, int kD, int kG, typename Gm = Geom<T, kD>>
inline bool plan_fits(const Args& a, int quantum, int stages) {
  return quantum == Gm::kQuantum && stages == Gm::kStages && a.B <= kMaxBatch &&
         a.target > 0 && a.n_split_max > 0 &&
         merge_floats<kD, kG>() * 4 <= kRingBytes &&
         combine_floats<kD, kG>(a.n_split_max) * 4 <= kRingBytes;
}

// Calls f.template operator()<T, kD, kG>() for the dtype code, head dim and
// group size the kernels are built for (f32 or bf16; D 16 or 128; G 1 or
// 4: llama2-7b's and qwen3-8b's, full and reduced), else returns
// cudaErrorInvalidValue.
template <typename T, int kD, typename F>
cudaError_t dispatch_g(int G, const F& f) {
  switch (G) {
    case 1: return f.template operator()<T, kD, 1>();
    case 4: return f.template operator()<T, kD, 4>();
    default: return cudaErrorInvalidValue;
  }
}
template <typename T, typename F>
cudaError_t dispatch_d(int D, int G, const F& f) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(G, f);
    case 128: return dispatch_g<T, 128>(G, f);
    default: return cudaErrorInvalidValue;
  }
}
template <typename F>
cudaError_t dispatch(int dtype, int D, int G, const F& f) {
  if (dtype == DTYPE_F32) return dispatch_d<float>(D, G, f);
  if (dtype == DTYPE_BF16) return dispatch_d<__nv_bfloat16>(D, G, f);
  return cudaErrorInvalidValue;
}

}  // namespace decode_split
