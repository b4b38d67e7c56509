// Prefill-shaped matrix product: out[M, N] = x[M, K] @ w[K, N], accumulated
// in f32, written in x's dtype (f32 or bf16; w in the same dtype).
//
// Replaces: src/repro/kernels/gemm_cim.py:39 matmul (the Pallas kernel
// _matmul_kernel, :25) — the TPU stand-in for HALO's CiM prefill GEMM.  The
// JAX package calls it from no model code; the port reaches it through its
// benchmark runner (repro_torch/benchmarks/kernel_micro.py).
//
// What bounds it on the H100: operations.  At 2048 x 4096 x 12288 (a
// 2048-token chunk through qwen3-8b's gate/up projection) in bf16 the
// product is 2MKN = 206 GFLOP against (MK + KN + MN) x 2 = 168 MB: 1229
// operations per byte, far above the ~295 at which the tensor cores
// rather than memory bind, so the least time is 206 GFLOP / 989 TFLOP/s =
// 0.208 ms (0.050 ms of bytes).  In f32 the CUDA cores' 67 TFLOP/s make it
// 3.08 ms.
//
// HALO's weight-stationary dataflow, mapped onto the card: the crossbar
// loads a weight tile once and streams many activation rows through it.
// Here each output tile's f32 accumulator stays in registers for its whole
// K walk (the Pallas kernel keeps it in VMEM scratch across its innermost
// grid axis), and tiles are taken M tile fastest, so the blocks that run
// together share a weight column tile, which comes from device memory
// about once and is re-read from L2 by every activation row tile.
//
// Two routes behind one entry point; the wrapper (kernels/gemm_cim.py
// route) picks and passes its choice, and inputs the route cannot take are
// refused:
//
// ROUTE_WGMMA, bf16 with K and N multiples of 8 and 16-byte aligned x, w
// and out (what TMA can address) — gemm_wgmma_kernel.  A persistent grid of
// at most one block per SM walks the output tiles (128 x kBN, kBN = 256, or
// 128 when 256-column tiles would leave SMs idle: the wrapper's choice).  A
// block is one producer warpgroup, which hands back its registers
// (setmaxnreg) and of which one thread issues the TMA loads, and two
// consumer warpgroups of 64 rows each.  The producer fills a ring of
// kStages stages, each x's [128 x 64] tile (K-major) and w's [64 x kBN]
// tile (MN-major: w is row-major [K, N], the transposed B operand bf16
// allows), both in the 128-byte swizzle, guarded by `full` (TMA bytes) and
// `empty` (one arrival per consumer warp) mbarriers.  Each consumer issues
// wgmma m64n<kBN>k16 for the stage's four K steps, commits, and waits only
// for the previous stage's group before releasing that stage, so one group
// is in flight while the next stage lands.  The epilogue rounds to bf16
// into a swizzled shared tile and writes it with TMA stores, which clip
// rows past M and columns past N; TMA loads zero-fill past M, N and K, so
// partial tiles need no other code.
//
// ROUTE_TILE, any shape in f32 or bf16:
//
// bf16 (gemm_bf16): tensor cores through mma.sync m16n8k16 with f32
// accumulators.  128 x 128 block tiles, 8 warps, 2 along M x 4 along N,
// each a 64 x 32 sub-tile.  K steps of 32 are staged in shared memory by
// 16-byte cp.async copies in a ring of 3 stages.  x's tile is read with
// ldmatrix, w's (row-major [K, N], so the B operand is K-major) with
// ldmatrix.trans; rows are padded by 16 bytes, so neither read has bank
// conflicts.
//
// f32 (gemm_f32): the tensor cores have no IEEE f32 mode and the port keeps
// TF32 off, so CUDA-core FMAs: 128 x 128 tiles, K steps of 8, each thread
// an 8 x 8 block of the output; the next step's tile is loaded into
// registers while the current one is multiplied (two shared-memory
// buffers, one barrier a step).  Each output sums its K products in order.
//
// On the tile, edge tiles are predicated (rows past M, columns past N and
// K past its end load as zero and are never stored).  The 16-byte copies
// need K and N to be multiples of 8 (bf16) or 4 (f32) and 16-byte aligned
// pointers; otherwise the tiles are loaded element by element.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128, kBN = 128;  // output tile of a block
constexpr int kThreads = 256;        // 8 warps

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBK = 32;              // K per stage
constexpr int kStages = 3;
constexpr int kAs = kBK + 8;         // padded row of the x tile: 80 bytes
constexpr int kBs = kBN + 8;         // padded row of the w tile: 272 bytes
constexpr int kStageElems = kBM * kAs + kBK * kBs;
constexpr size_t kSmemBf16 = static_cast<size_t>(kStages) * kStageElems * 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with src_bytes 0 it writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) @ b (16 x 8, K-major), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage K step kt's x tile [kBM][kBK] and w tile [kBK][kBN]: 16-byte
// cp.async copies (zero-filled past M, N or K) when vec, else element by
// element.
__device__ __forceinline__ void load_stage_bf16(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                                const __nv_bfloat16* __restrict__ x,
                                                const __nv_bfloat16* __restrict__ w, int M,
                                                int N, int K, int m0, int n0, int kt,
                                                bool vec) {
  const int k0 = kt * kBK;
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < K;
      const __nv_bfloat16* src = ok ? x + static_cast<size_t>(m0 + r) * K + k0 + kc : x;
      cp_async16(As + r * kAs + kc, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + nc < N;
      const __nv_bfloat16* src = ok ? w + static_cast<size_t>(k0 + r) * N + n0 + nc : w;
      cp_async16(Bs + r * kBs + nc, src, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK;
      As[r * kAs + k] = (m0 + r < M && k0 + k < K)
                            ? x[static_cast<size_t>(m0 + r) * K + k0 + k]
                            : zero;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, n = i % kBN;
      Bs[r * kBs + n] = (k0 + r < K && n0 + n < N)
                            ? w[static_cast<size_t>(k0 + r) * N + n0 + n]
                            : zero;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
          __nv_bfloat16* __restrict__ out, int M, int N, int K, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / 4, wn = warp % 4;  // 64-row, 32-column sub-tile
  const int nk = (K + kBK - 1) / kBK;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      __nv_bfloat16* As = smem + s * kStageElems;
      load_stage_bf16(As, As + kBM * kAs, x, w, M, N, K, m0, n0, s, vec);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // step kt has landed
    __syncthreads();               // ... for every thread; step kt-1 is consumed
    const int nt = kt + kStages - 1;
    if (nt < nk) {
      __nv_bfloat16* As = smem + (nt % kStages) * kStageElems;
      load_stage_bf16(As, As + kBM * kAs, x, w, M, N, K, m0, n0, nt, vec);
    }
    cp_async_commit();

    const __nv_bfloat16* As = smem + (kt % kStages) * kStageElems;
    const __nv_bfloat16* Bs = As + kBM * kAs;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], As + (wm * 64 + i * 16 + (lane % 16)) * kAs + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Bs + (kk + (lane % 16)) * kBs + wn * 32 + j * 16 + (lane / 16) * 8);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + lane / 4 + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + (lane % 4) * 2 + e;
          if (n < N)
            out[static_cast<size_t>(m) * N + n] = __float2bfloat16(acc[i][j][2 * h + e]);
        }
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBK32 = 8;  // K per step

__device__ __forceinline__ void load4(const float* __restrict__ p, bool whole, bool vec,
                                      int valid, float* r) {
  if (whole && vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = i < valid ? p[i] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
         int M, int N, int K, int vec) {
  __shared__ __align__(16) float As[2][kBK32][kBM];  // x's tile, K-major
  __shared__ __align__(16) float Bs[2][kBK32][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = (K + kBK32 - 1) / kBK32;
  // this thread's loads: 4 K values of x row ar, 4 columns of w row bk
  const int ar = tid / 2, ak = (tid % 2) * 4;
  const int bk = tid / 32, bn = (tid % 32) * 4;
  float ra[4], rb[4];

  auto load = [&](int kt) {
    const int k = kt * kBK32 + ak;
    const int va = (m0 + ar < M) ? min(4, K - k) : 0;
    load4(x + static_cast<size_t>(min(m0 + ar, M - 1)) * K + min(k, K - 1), va == 4, vec,
          va, ra);
    const int kb = kt * kBK32 + bk;
    const int vb = (kb < K) ? min(4, N - (n0 + bn)) : 0;
    load4(w + static_cast<size_t>(min(kb, K - 1)) * N + min(n0 + bn, N - 1), vb == 4, vec,
          vb, rb);
  };
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[s][ak + i][ar] = ra[i];
    *reinterpret_cast<float4*>(&Bs[s][bk][bn]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % 2;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][k][64 + tx * 4]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(s ^ 1);  // the buffer step kt-1 used: every
    __syncthreads();                // thread passed the barrier after it
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      float* o = out + static_cast<size_t>(m) * N + n;
      if (vec && n + 4 <= N) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) o[e] = acc[i][4 * h + e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA-fed ring (ROUTE_WGMMA)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                  // rows of an output tile
constexpr int kBK = 64;                   // K per stage: one 128-byte row
constexpr int kConsumers = 2;             // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kChunk = 64 * 64;           // bf16 of a 64 x 64 swizzled box

template <int kBN>
struct Smem {
  static constexpr int kStages = kBN == 256 ? 3 : 5;
  static constexpr int kC = kBN / 64;     // 64-column chunks of a tile
  bf16 a[kStages][kBM * kBK];             // x: 128 rows of 64 K, K-major
  bf16 b[kStages][kC][kChunk];            // w: 64 K rows of 64 columns per chunk
  bf16 c[kConsumers][kC][kChunk];         // the epilogue's 64 x kBN tile per consumer
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int kBN>
inline size_t smem_bytes() {
  return sizeof(Smem<kBN>) + 1024;
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap c_map, int M, int N, int K) {
  using S = Smem<kBN>;
  constexpr int kStages = S::kStages, kC = S::kC;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(align1024(smem_raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int m_tiles = (M + kBM - 1) / kBM;
  const int tiles = m_tiles * ((N + kBN - 1) / kBN);
  const int nk = (K + kBK - 1) / kBK;
  const int role = threadIdx.x / 128, t = threadIdx.x % 128;

  if (role == kConsumers) {
    // producer: one thread issues every load; the warpgroup's registers go
    // to the consumers
    setmaxnreg_dec<40>();
    if (t != 0) return;
    constexpr uint32_t kBytes = (kBM * kBK + kBK * kBN) * 2;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * kBM, n0 = (tile / m_tiles) * kBN;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&sm.empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&sm.full[stage], kBytes);
        tma_load_2d(&sm.a[stage][0], &a_map, &sm.full[stage], kt * kBK, m0);
#pragma unroll
        for (int c = 0; c < kC; ++c)
          tma_load_2d(&sm.b[stage][c][0], &b_map, &sm.full[stage], n0 + c * 64, kt * kBK);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);            // and columns 8 j + c2 (+ 1)
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * kBM, n0 = (tile / m_tiles) * kBN;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&sm.full[stage], phase);
      const uint64_t da = desc(&sm.a[stage][role * 64 * kBK], 16, 1024);
      const uint64_t db = desc(&sm.b[stage][0][0], kChunk * 2, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)  // 32 bytes along A's rows, 16 rows of B
        wgmma_ss<kBN, 0, 1>(acc, da + ((ks * 32) >> 4), db + ((ks * 16 * 128) >> 4), 1);
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

    // epilogue: the previous tile's stores have read the shared tile, then
    // bf16 pairs into the 128-byte swizzle (chunk j / 8, 16-byte group j % 8
    // of row r at (j % 8) ^ (r % 8)), then TMA stores of the 64-row slab
    if (t == 0) bulk_wait_read();
    bar_sync(1 + role, 128);
    bf16* c_s = &sm.c[role][0][0];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(
            c_s + (j / 8) * kChunk + r * 64 + (((j % 8) ^ (r & 7)) * 8) + c2) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async();
    bar_sync(1 + role, 128);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        tma_store_2d(&c_map, &sm.c[role][c][0], n0 + c * 64, m0 + role * 64);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
}

template <int kBN>
cudaError_t launch(const void* x, const void* w, void* out, int M, int K, int N,
                   cudaStream_t st) {
  // x [M, K] in boxes of 64 K x 128 rows; w [K, N] and out [M, N] in boxes
  // of 64 columns x 64 rows; all in the 128-byte swizzle
  CUtensorMap a_map, b_map, c_map;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t b_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t c_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
  const uint64_t a_stride[1] = {static_cast<uint64_t>(K) * 2};
  const uint64_t n_stride[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t a_box[2] = {kBK, kBM}, bc_box[2] = {64, 64};
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto kSw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&a_map, kBf16, 2, x, a_dims, a_stride, a_box, kSw) ||
      !tensor_map(&b_map, kBf16, 2, w, b_dims, n_stride, bc_box, kSw) ||
      !tensor_map(&c_map, kBf16, 2, out, c_dims, n_stride, bc_box, kSw))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<kBN>();
  cudaError_t err = allow_smem(gemm_wgmma_kernel<kBN>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  gemm_wgmma_kernel<kBN><<<tiles < sms ? tiles : sms, kThreads, smem, st>>>(a_map, b_map,
                                                                           c_map, M, N, K);
  return cudaGetLastError();
}

}  // namespace wg

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x [M,K], w [K,N], out [M,N], all in one dtype (DTYPE_F32 or DTYPE_BF16),
// contiguous, on the stream's device.  `route` is the wrapper's choice and
// the kernel launched: ROUTE_WGMMA takes bf16 with K and N multiples of 8
// and 16-byte aligned x, w and out, in output tiles of 128 x `block_n`
// columns (128 or 256); ROUTE_TILE takes either dtype at any shape
// (`block_n` unused).  Inputs the route cannot take are refused with
// cudaErrorInvalidValue, nothing launched.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int gemm_cim(int dtype, int route, int block_n, const void* x, const void* w,
                        void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_WGMMA) {
    if (dtype != DTYPE_BF16 || K % 8 != 0 || N % 8 != 0 || !aligned16(x) || !aligned16(w) ||
        !aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
    if (block_n == 256) return static_cast<int>(wg::launch<256>(x, w, out, M, K, N, st));
    if (block_n == 128) return static_cast<int>(wg::launch<128>(x, w, out, M, K, N, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != ROUTE_TILE) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DTYPE_BF16) {
    const int vec = K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(w);
    cudaError_t err = allow_smem(gemm_bf16, kSmemBf16);
    if (err != cudaSuccess) return static_cast<int>(err);
    gemm_bf16<<<grid, kThreads, kSmemBf16, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, N, K, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == DTYPE_F32) {
    const int vec =
        K % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(out);
    gemm_f32<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(w),
                                        static_cast<float*>(out), M, N, K, vec);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
