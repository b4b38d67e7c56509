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
// so the kernel is a weight stream: K*N bytes at 3.35 TB/s.
//
// Layout, in two passes (split-K):
//
// 1. gemv_partial — one block per (column tile of kBN columns, K chunk of
//    kc rows).  A block of 4 warps reads its weight tile with 16-byte
//    loads: in a warp, 8 lanes cover 8 neighbouring 16-byte column groups
//    of one row and the 4 lane groups take 4 rows, so every load
//    instruction reads 4 full 128-byte lines; the 4 warps interleave rows
//    as well (16 rows per block step), and each thread issues the loads of
//    kUnroll steps before it uses any, so that enough bytes are in flight
//    to cover the memory latency.  x's rows for the chunk
//    sit in shared memory as f32, so each weight value is converted once
//    and multiplied into kMB rows of x held in registers.  Splitting K
//    across blocks is what fills the card: qwen3-8b's wk (N = 1024) has
//    only 8 column tiles, one wave's worth of blocks needs ~16 K chunks
//    each.  The partial sums of the 16 row lanes are reduced with warp
//    shuffles and then through shared memory, and the block writes one f32
//    partial [M, kBN] per chunk.  Rows of x beyond kMB are taken kMB at a
//    time (the weight tile is then re-read, from L2).
// 2. gemv_combine — sums the chunks in order (deterministic, no float
//    atomics), multiplies by scale[n] once (the reference's epilogue
//    dequant) and rounds to x's dtype.
//
// Ragged shapes: the K tail is a shorter last chunk; an N tail (or a weight
// that is not 16-byte aligned) is read element by element and never past
// column N.
#include <cstdint>

#include "common.cuh"

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

}  // namespace

// x [M,K] (dtype DTYPE_F32/BF16); w [K,N] int8 (w_dtype W_INT8) or in x's
// dtype; scale [N] f32 or null; out [M,N] in x's dtype; part [n_chunks,M,N]
// f32 scratch with n_chunks = ceil(K / kc), kc a multiple of 16 no larger
// than 2048.  All contiguous, all on the stream's device.  Returns the CUDA
// error code of the launches (0 on success).
extern "C" int gemv_int8(int dtype, int w_dtype, const void* x, const void* w,
                         const void* scale, void* out, void* part, int M, int K,
                         int N, int kc, int n_chunks, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || kc <= 0 || kc % 16 != 0 || kc > 2048 ||
      n_chunks != (K + kc - 1) / kc || static_cast<long long>(M) * N > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
