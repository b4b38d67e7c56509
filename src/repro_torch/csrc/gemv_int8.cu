// Decode-shaped matrix product with int8 weights: out[M, N] = (x[M, K] @
// w[K, N]) * scale[N], accumulated in f32, written in x's dtype.  The same
// kernel serves float weights (w in x's dtype) with no scale.
//
// Replaces: src/repro/kernels/gemv_cid.py:74 gemv (the Pallas kernels
// _gemv_q_kernel and _gemv_kernel), called for every matmul whose token dim
// is at most 8 when weights are int8 (src/repro/models/layers.py:178) —
// HALO's CiD decode datapath.
//
// What bounds it on the H100: bytes.  Each weight byte is read once and
// feeds 2*M operations; at the decode batches served (M <= 32) that is far
// below the ~295 operations per byte at which the tensor cores would bind,
// so the kernel is a weight stream: K*N bytes at 3.35 TB/s.  Keeping that
// stream full takes some 25-50 KB of loads in flight per SM, and the
// arithmetic must stay off the loads' way.
//
// Two routes behind one entry point; the wrapper (kernels/gemv_cid.py
// route) picks and passes its choice, and inputs the route cannot take are
// refused.  Both split K into n_chunks chunks of kc rows to fill the card
// and sum a column tile's f32 chunk partials in chunk order, so the result
// does not depend on which block finishes first; the scale[n] is applied
// once to that sum (the reference's epilogue dequant).  The partials live
// in the wrapper's scratch, allocated once per device.
//
// ROUTE_WGMMA, bf16 x with M <= 32 (int8 or bf16 weights whose rows are
// 16-byte aligned, K a multiple of 8, x 16-byte aligned) —
// gemv_wgmma_kernel.  The product is taken transposed, out^T [N, M] = w^T
// x^T, so that 64 output columns fill wgmma's M and the decode batch, padded
// to kNB = 8, 16 or 32, is its N.  A persistent grid (as many blocks as fit
// an SM: three at kNB = 8) walks work units of (128 columns, one K chunk),
// about one a block.  The weights are read once, with an evict-first L2
// hint.  A block is one producer
// warp and two consumer warpgroups of 64 columns each.  The producer streams
// the units' stages by TMA into a ring of kStages: w's [64 k x 64 n] tile
// per consumer (int8 plain rows, or bf16 already in the 128-byte swizzle)
// and x's [kNB x 64 k] tile (K-major, 128-byte swizzle; rows past M and K
// past its end are TMA's zero fill).  An int8 tile is converted by its
// consumer into a bf16 staging tile, MN-major in the 128-byte swizzle — the
// layout w has, read as wgmma's transposed A — two at a time so that one
// converts while the other's product runs: q ^ 0x80 into the low byte of
// the f32 2^23 gives 2^23 + 128 + q, one subtraction gives q, and the high
// half of that f32 is q in bf16, exact since |q| <= 127.  wgmma
// m64n<kNB>k16 then takes bf16 x bf16 products, exact in f32, with f32
// accumulation.  Each consumer waits only for the previous stage's group
// before releasing that stage.  At the end of a unit each block writes its
// f32 partial [M, 128] (or, with one chunk, the result), and the last block
// to arrive at a column tile (an atomic counter per tile, reset by that
// block for the next launch) sums the tile's partials in chunk order,
// scales, rounds and writes the result: one launch per call.
//
// ROUTE_TILE, any input (f32 or bf16 x), in two launches:
//
// 1. gemv_partial — one block per (column tile of kBN columns, K chunk of
//    kc rows).  A block of 4 warps reads its weight tile with 16-byte
//    loads: in a warp, 8 lanes cover 8 neighbouring 16-byte column groups
//    of one row and the 4 lane groups take 4 rows, so every load
//    instruction reads 4 full 128-byte lines; the 4 warps interleave rows
//    as well (16 rows per block step), and each thread issues the loads of
//    kUnroll steps before it uses any.  x's rows for the chunk sit in
//    shared memory as f32, so each weight value is converted once and
//    multiplied into kMB rows of x held in registers.  The partial sums of
//    the 16 row lanes are reduced with warp shuffles and then through
//    shared memory, and the block writes one f32 partial [M, kBN] per
//    chunk.  Rows of x beyond kMB are taken kMB at a time (the weight tile
//    is then re-read, from L2).
// 2. gemv_combine — sums the chunks in order, multiplies by scale[n] once
//    and rounds to x's dtype.
//
// Ragged shapes: the K tail is a shorter last chunk; on the tile an N tail
// (or a weight that is not 16-byte aligned) is read element by element and
// never past column N; on the tensor cores TMA zero-fills a partial tile
// and the epilogue writes no column past N.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kColLanes = 8;    // 16-byte column groups per warp row
constexpr int kRowLanes = 16;   // rows per block step (4 per warp)
constexpr int kUnroll = 4;      // block steps whose loads a thread issues at once

enum { W_INT8 = 2 };            // weight dtype code beside DTYPE_F32/BF16

// elements of W in one 16-byte load
template <typename W> struct Vec;
template <> struct Vec<int8_t> { static constexpr int n = 16; };
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

__device__ __forceinline__ float w_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float w_f32(float v) { return v; }
__device__ __forceinline__ float w_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load16(const int8_t* p, float* f) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)  // byte j, sign-extended by the shift pair
      f[4 * i + j] = static_cast<float>((w[i] << (24 - 8 * j)) >> 24);
}

__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i in the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, typename W, int kMB>
__global__ void __launch_bounds__(kThreads)
gemv_partial(const T* __restrict__ x, const W* __restrict__ w,
             float* __restrict__ part, int M, int K, int N, int kc, int vec_ok) {
  constexpr int kV = Vec<W>::n;
  constexpr int kBN = kColLanes * kV;
  constexpr int kWarps = kThreads / 32;
  const int tile = blockIdx.x, chunk = blockIdx.y;
  const int k0 = chunk * kc, k1 = min(k0 + kc, K), nk = k1 - k0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane % kColLanes;
  const int rl = warp * (32 / kColLanes) + lane / kColLanes;   // 0..15
  const int col0 = tile * kBN + cg * kV;
  const bool whole = vec_ok && col0 + kV <= N;

  extern __shared__ float smem[];
  float* x_s = smem;                  // [kMB][kc] x rows of this chunk, f32
  float* red = x_s + kMB * kc;        // [kWarps][kMB][kBN] warp partials

  for (int m0 = 0; m0 < M; m0 += kMB) {
    const int mb = min(kMB, M - m0);
    __syncthreads();                  // the previous rows' reads are done
    for (int i = threadIdx.x; i < kMB * nk; i += kThreads) {
      const int m = i / nk, k = i % nk;
      x_s[m * kc + k] =
          m < mb ? to_f32(x[static_cast<size_t>(m0 + m) * K + k0 + k]) : 0.f;
    }
    __syncthreads();

    float acc[kMB][kV];
#pragma unroll
    for (int m = 0; m < kMB; ++m)
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[m][v] = 0.f;

    for (int kb = rl; kb < nk; kb += kRowLanes * kUnroll) {
      // issue the kUnroll rows' loads before any is used, so that many
      // bytes are in flight per thread (a row past the chunk re-reads its
      // last row, which stays in bounds, and is not added)
      float wv[kUnroll][kV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = min(kb + u * kRowLanes, nk - 1);
        const W* row = w + static_cast<size_t>(k0 + k) * N + col0;
        if (whole) {
          load16(row, wv[u]);
        } else {
#pragma unroll
          for (int v = 0; v < kV; ++v) wv[u][v] = col0 + v < N ? w_f32(row[v]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kRowLanes;
        if (k >= nk) break;
#pragma unroll
        for (int m = 0; m < kMB; ++m) {
          const float xm = x_s[m * kc + k];
#pragma unroll
          for (int v = 0; v < kV; ++v) acc[m][v] = fmaf(xm, wv[u][v], acc[m][v]);
        }
      }
    }

    // the 4 row lanes of a warp (lane bits 3 and 4), then the 4 warps
#pragma unroll
    for (int m = 0; m < kMB; ++m)
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        float a = acc[m][v];
        a += __shfl_xor_sync(0xffffffffu, a, 8);
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        acc[m][v] = a;
      }
    if (lane < kColLanes) {
#pragma unroll
      for (int m = 0; m < kMB; ++m)
#pragma unroll
        for (int v = 0; v < kV; ++v)
          red[(warp * kMB + m) * kBN + cg * kV + v] = acc[m][v];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < mb * kBN; i += kThreads) {
      const int m = i / kBN, c = i % kBN, n = tile * kBN + c;
      if (n >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) s += red[(g * kMB + m) * kBN + c];
      part[(static_cast<size_t>(chunk) * M + m0 + m) * N + n] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
gemv_combine(const float* __restrict__ part, const float* __restrict__ scale,
             T* __restrict__ out, int M, int N, int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float s = 0.f;
  for (int z = 0; z < n_chunks; ++z) s += part[static_cast<size_t>(z) * M * N + i];
  if (scale != nullptr) s *= scale[i % N];
  out[i] = from_f32<T>(s);
}

template <typename T, typename W, int kMB>
cudaError_t launch_mb(const void* x, const void* w, const void* scale, void* out,
                      void* part, int M, int K, int N, int kc, int n_chunks,
                      int vec_ok, cudaStream_t st) {
  constexpr int kBN = kColLanes * Vec<W>::n;
  const size_t smem =
      (static_cast<size_t>(kMB) * kc + (kThreads / 32) * kMB * kBN) * sizeof(float);
  cudaError_t err = allow_smem(gemv_partial<T, W, kMB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, n_chunks);
  gemv_partial<T, W, kMB><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<float*>(part),
      M, K, N, kc, vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemv_combine<T><<<(M * N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<T*>(out), M, N, n_chunks);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   void* part, int M, int K, int N, int kc, int n_chunks,
                   cudaStream_t st) {
  // 16-byte loads need 16-byte aligned rows
  const int vec_ok = (N % Vec<W>::n == 0) &&
                     (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (M == 1)
    return launch_mb<T, W, 1>(x, w, scale, out, part, M, K, N, kc, n_chunks, vec_ok, st);
  if (M == 2)
    return launch_mb<T, W, 2>(x, w, scale, out, part, M, K, N, kc, n_chunks, vec_ok, st);
  return launch_mb<T, W, 4>(x, w, scale, out, part, M, K, N, kc, n_chunks, vec_ok, st);
}

// ---------------------------------------------------------------------------
// bf16 x: wgmma, TMA-fed ring (ROUTE_WGMMA)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                   // K rows per stage
constexpr int kWG = 2;                    // consumer warpgroups, 64 columns each
constexpr int kBN = 64 * kWG;             // output columns per work unit
constexpr int kStages = 4;                // depth of the ring (three blocks an SM)
constexpr int kThreads = 128 * kWG + 32;  // + the producer warp
constexpr int kTile = 64 * 64;            // elements of a 64 k x 64 n tile

// kW: bytes of a weight element (1: int8, 2: bf16); kNB: x's rows padded
template <int kW, int kNB>
struct Smem {
  unsigned char w[kStages][kWG][kTile * kW];  // int8 rows, or bf16 swizzled
  bf16 x[kStages][kNB * kBK];                 // x: kNB rows of 64 k, swizzled
  bf16 a[kW == 1 ? kWG : 1][2][kTile];        // int8 only: converted tiles
  uint64_t full[kStages];
  uint64_t empty[kStages];
  int last;                                   // this block closes its tile
};

template <int kW, int kNB>
inline size_t smem_bytes() {
  return sizeof(Smem<kW, kNB>) + 1024;
}

// one consumer's int8 tile [64 k][64 n] (64-byte rows) to bf16 in the
// 128-byte swizzle (16-byte group g of row k at g ^ (k % 8)); thread t
// converts 16 contiguous bytes twice: rows t / 4 and 32 + t / 4, columns
// 16 (t % 4) ... + 15, so every 8 threads read 128 contiguous bytes and
// write 8 distinct bank groups
__device__ __forceinline__ void convert(const unsigned char* __restrict__ q, bf16* a, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = t / 4 + 32 * h, g0 = 2 * (t % 4);
    const uint4 v = *reinterpret_cast<const uint4*>(q + k * 64 + 16 * (t % 4));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.f;
      p[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      p[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint4*>(a + k * 64 + (((g0 + j) ^ (k & 7)) * 8)) =
          make_uint4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
  }
}

template <int kW, int kNB>
__global__ void __launch_bounds__(kThreads)
gemv_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap x_map, const float* __restrict__ scale,
                  bf16* __restrict__ out, float* __restrict__ part,
                  unsigned* __restrict__ counters, int M, int K, int N, int kc,
                  int n_chunks) {
  using S = Smem<kW, kNB>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * kWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int n_tiles = (N + kBN - 1) / kBN;
  const int units = n_tiles * n_chunks;
  const int role = threadIdx.x / 128, t = threadIdx.x % 128;

  if (role == kWG) {
    // producer: lane 0 of the last warp issues every load
    if (t != 0) return;
    constexpr uint32_t kBytes = kWG * kTile * kW + kNB * kBK * 2;
    int stage = 0, phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int n0 = (u % n_tiles) * kBN, k0 = (u / n_tiles) * kc;
      const int k1 = min(k0 + kc, K);
      for (int k = k0; k < k1; k += kBK) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&sm.full[stage], kBytes);
#pragma unroll
        for (int g = 0; g < kWG; ++g)
          tma_load_2d_once(&sm.w[stage][g][0], &w_map, &sm.full[stage], n0 + 64 * g, k);
        tma_load_2d(&sm.x[stage][0], &x_map, &sm.full[stage], k, 0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's columns n0 + 64 role + r0 (+ 8)
  const int c2 = 2 * (lane % 4);            // and rows m = 8 j + c2 (+ 1)
  int stage = 0, phase = 0, it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u % n_tiles, chunk = u / n_tiles;
    const int n0 = tile * kBN, k0 = chunk * kc;
    const int nk = (min(k0 + kc, K) - k0 + kBK - 1) / kBK;
    float acc[kNB / 2];
#pragma unroll
    for (int i = 0; i < kNB / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int i = 0; i < nk; ++i, ++it) {
      mbar_wait(&sm.full[stage], phase);
      uint64_t da;
      if constexpr (kW == 1) {
        // the staging tile was last read by the group before the previous
        // one, which every warp has waited for: the barrier makes sure
        bf16* a = &sm.a[role][it & 1][0];
        bar_sync(1 + role, 128);
        convert(&sm.w[stage][role][0], a, t);
        fence_proxy_async();
        bar_sync(1 + role, 128);
        da = desc(a, kTile * 2, 1024);
      } else {
        da = desc(&sm.w[stage][role][0], kTile * 2, 1024);
      }
      const uint64_t dx = desc(&sm.x[stage][0], 16, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)  // 16 rows of A, 32 bytes along x's rows
        wgmma_ss<kNB, 1, 0>(acc, da + ((ks * 16 * 128) >> 4), dx + ((ks * 32) >> 4), 1);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // the previous stage's group is done: free it
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[prev]);

    // this unit's [M, 64] slab: the result when K is one chunk, else the
    // chunk's f32 partial, and the last block of the tile closes it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * role + r0 + 8 * h;
      if (n >= N) continue;
      const float s = n_chunks == 1 && scale != nullptr ? scale[n] : 1.f;
#pragma unroll
      for (int j = 0; j < kNB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * j + c2 + e;
          if (m >= M) continue;
          const float v = acc[4 * j + 2 * h + e];
          if (n_chunks == 1)
            out[static_cast<size_t>(m) * N + n] = __float2bfloat16(v * s);
          else
            part[(static_cast<size_t>(chunk) * M + m) * N + n] = v;
        }
    }
    if (n_chunks == 1) continue;
    __threadfence();
    bar_sync(3, 128 * kWG);
    if (threadIdx.x == 0) sm.last = atomicAdd(&counters[tile], 1u) == n_chunks - 1u;
    bar_sync(3, 128 * kWG);
    if (sm.last) {
      __threadfence();
      for (int i = threadIdx.x; i < M * kBN; i += 128 * kWG) {
        const int m = i / kBN, n = n0 + i % kBN;
        if (n >= N) continue;
        const float* p = part + static_cast<size_t>(m) * N + n;
        float s = 0.f;
#pragma unroll 8  // the loads in flight together; the sum stays in chunk order
        for (int z = 0; z < n_chunks; ++z) s += __ldcg(p + static_cast<size_t>(z) * M * N);
        if (scale != nullptr) s *= scale[n];
        out[static_cast<size_t>(m) * N + n] = __float2bfloat16(s);
      }
      if (threadIdx.x == 0) counters[tile] = 0;
    }
  }
}

template <int kW, int kNB>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, void* part,
                   void* counters, int M, int K, int N, int kc, int n_chunks,
                   cudaStream_t st) {
  // w [K, N] in boxes of 64 columns x 64 rows (int8: plain; bf16: 128-byte
  // swizzle); x [M, K] in boxes of 64 k x kNB rows, 128-byte swizzle
  CUtensorMap w_map, x_map;
  const uint64_t w_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t w_stride[1] = {static_cast<uint64_t>(N) * kW};
  const uint64_t x_stride[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t w_box[2] = {64, 64}, x_box[2] = {kBK, kNB};
  if (!tensor_map(&w_map,
                  kW == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  w, w_dims, w_stride, w_box,
                  kW == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_stride, x_box,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kernel = gemv_wgmma_kernel<kW, kNB>;
  const size_t smem = smem_bytes<kW, kNB>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int units = (N + kBN - 1) / kBN * n_chunks;
  const int slots = per_sm * sm_count();
  if (slots <= 0) return cudaErrorInvalidValue;
  kernel<<<units < slots ? units : slots, kThreads, smem, st>>>(
      w_map, x_map, static_cast<const float*>(scale), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(counters), M, K, N, kc, n_chunks);
  return cudaGetLastError();
}

template <int kW>
cudaError_t launch_nb(const void* x, const void* w, const void* scale, void* out, void* part,
                      void* counters, int M, int K, int N, int kc, int n_chunks,
                      cudaStream_t st) {
  if (M <= 8)
    return launch<kW, 8>(x, w, scale, out, part, counters, M, K, N, kc, n_chunks, st);
  if (M <= 16)
    return launch<kW, 16>(x, w, scale, out, part, counters, M, K, N, kc, n_chunks, st);
  return launch<kW, 32>(x, w, scale, out, part, counters, M, K, N, kc, n_chunks, st);
}

}  // namespace wg

}  // namespace

// x [M,K] (dtype DTYPE_F32/BF16); w [K,N] int8 (w_dtype W_INT8) or in x's
// dtype; scale [N] f32 or null; out [M,N] in x's dtype; part f32 scratch of
// at least n_chunks*M*N and counters [ceil(N/128)] unsigned, all zero, both
// the wrapper's, on one stream at a time; K split into n_chunks = ceil(K /
// kc) chunks.  All contiguous, all on the stream's device.  `route` is the
// wrapper's choice and the kernel launched: ROUTE_WGMMA takes bf16 x with
// M <= 32, K a multiple of 8, kc a multiple of 64, and int8 (N a multiple
// of 16) or bf16 (N a multiple of 8) weights, x and w 16-byte aligned, and
// leaves the counters zero; ROUTE_TILE takes any input with kc a multiple
// of 16 no larger than 2048.  Inputs the route cannot take are refused with
// cudaErrorInvalidValue, nothing launched.  Returns the CUDA error code of
// the launches (0 on success).
extern "C" int gemv_int8(int dtype, int route, int w_dtype, const void* x, const void* w,
                         const void* scale, void* out, void* part, void* counters, int M,
                         int K, int N, int kc, int n_chunks, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || kc <= 0 || n_chunks != (K + kc - 1) / kc ||
      static_cast<long long>(M) * N > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (route == ROUTE_WGMMA) {
    if (dtype != DTYPE_BF16 || M > 32 || K % 8 != 0 || kc % wg::kBK != 0 || !aligned)
      return cudaErrorInvalidValue;
    if (w_dtype == W_INT8 && N % 16 == 0)
      return static_cast<int>(
          wg::launch_nb<1>(x, w, scale, out, part, counters, M, K, N, kc, n_chunks, st));
    if (w_dtype == DTYPE_BF16 && scale == nullptr && N % 8 == 0)
      return static_cast<int>(
          wg::launch_nb<2>(x, w, nullptr, out, part, counters, M, K, N, kc, n_chunks, st));
    return cudaErrorInvalidValue;
  }
  if (route != ROUTE_TILE || kc % 16 != 0 || kc > 2048) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == DTYPE_F32) {
    if (w_dtype == W_INT8)
      err = launch<float, int8_t>(x, w, scale, out, part, M, K, N, kc, n_chunks, st);
    else if (w_dtype == DTYPE_F32)
      err = launch<float, float>(x, w, scale, out, part, M, K, N, kc, n_chunks, st);
  } else if (dtype == DTYPE_BF16) {
    if (w_dtype == W_INT8)
      err = launch<__nv_bfloat16, int8_t>(x, w, scale, out, part, M, K, N, kc, n_chunks,
                                          st);
    else if (w_dtype == DTYPE_BF16)
      err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, out, part, M, K, N, kc,
                                                 n_chunks, st);
  }
  return static_cast<int>(err);
}
