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
// Here each block owns one (128 x 128) output tile and walks K innermost
// with its f32 accumulator held in registers for the whole walk (the Pallas
// kernel keeps it in VMEM scratch across its innermost grid axis); blocks
// are launched M tile fastest, so the blocks that run together share a
// weight column tile, which comes from device memory about once and is
// re-read from L2 by every activation row tile.
//
// bf16 (gemm_bf16): tensor cores through mma.sync m16n8k16 with f32
// accumulators.  8 warps, 2 along M x 4 along N, each a 64 x 32 sub-tile.
// K steps of 32 are staged in shared memory by 16-byte cp.async copies in a
// ring of 3 stages, so two steps' loads are in flight while one is
// multiplied.  x's tile is read with ldmatrix, w's (row-major [K, N], so
// the B operand is K-major) with ldmatrix.trans; rows are padded by 16
// bytes, so neither read has bank conflicts.  wgmma and TMA come with a
// later redesign.
//
// f32 (gemm_f32): the tensor cores have no IEEE f32 mode and the port keeps
// TF32 off, so CUDA-core FMAs: 128 x 128 tiles, K steps of 8, each thread
// an 8 x 8 block of the output; the next step's tile is loaded into
// registers while the current one is multiplied (two shared-memory
// buffers, one barrier a step).  Each output sums its K products in order.
//
// Any shape: edge tiles are predicated (rows past M, columns past N and K
// past its end load as zero and are never stored).  The 16-byte copies need
// K and N to be multiples of 8 (bf16) or 4 (f32) and 16-byte aligned
// pointers; otherwise the tiles are loaded element by element.
#include <cstdint>

#include "common.cuh"

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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x [M,K], w [K,N], out [M,N], all in one dtype (DTYPE_F32 or DTYPE_BF16),
// contiguous, on the stream's device.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int gemm_cim(int dtype, const void* x, const void* w, void* out, int M, int K,
                        int N, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
