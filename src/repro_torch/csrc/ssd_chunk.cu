// Mamba-2 SSD inside each chunk (state-space duality, one B/C group): for
// every stacked chunk c and head h, with cs = cumsum(dt A) over the chunk,
//
//   y[i, :]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, :]
//   state    = sum_j B_j^T exp(cs_last - cs_j) dt_j x[j, :]      ([N, P])
//
// Replaces: src/repro/kernels/ssd_scan.py:64 ssd_chunk (the Pallas kernel
// _ssd_kernel, :31).  The port calls it from models/ssm.py ssd_chunked on
// every Mamba-2 prefill, once per layer, with the chunks of the prompt
// stacked; the inter-chunk recurrence stays in PyTorch.
//
// What bounds it on the H100: operations.  Per chunk and head it does
// about Q^2 P multiply-adds for y (the causal half of Q x Q x P twice) and
// Q N P for the state, against 2 (Q P + Q N) input values — at Q = 256,
// P = 64, N = 128 about 170 flops per input byte, and all of it in f32
// (the reference's arithmetic), whose CUDA-core peak is 67 TFLOP/s.
//
// Layout.  One block computes a 64-row output tile for up to 4 heads
// (kHeads, the TPU kernel's head block), so that every C B^T tile it builds
// serves all of them.  Pass 1 (ssd_y): rows are query positions i; it walks
// the key positions j <= the tile's last row in 32-row steps.  Each step
// builds the 64 x 32 tile of C B^T in registers (4 x 2 a thread) from the
// tile's C rows (kept transposed in shared memory for the whole walk) and
// the step's B rows; then, per head, it forms the weights
// G = CB exp(cs_i - cs_j) dt_j (exp only where j <= i: above the diagonal
// cs_i - cs_j can be positive and overflow), stores them beside the step's
// x rows, and adds G x into registers.  At Q = 256 the full f32 C B^T
// would be 256 KB, more than an SM's shared memory; a step needs 64 x 32
// of it.  Pass 2 (ssd_states): rows are state positions n, the weights
// are B itself, shared by the heads, and each head's x rows are scaled by
// exp(cs_last - cs_j) dt_j (Q exps a head); the walk covers every j.  Each
// thread keeps a 4 x P/16 tile per head, fed by 16-byte shared-memory
// loads.  Each block computes the cumulative sums of its heads itself (one
// warp per head).  All arithmetic is f32 whatever the input dtype; both
// outputs are f32.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;    // output rows per block: 16 row groups of 4
constexpr int kStep = 32;    // j positions per step of the walk
constexpr int kHeads = 4;    // heads per block
constexpr int kMaxQ = 256;   // the longest chunk (ssm_prefill's chunk)
constexpr int kLdT = kRows + 4;   // row stride of the [j][row] tiles: 16-byte aligned

// cs[j] = inclusive cumsum of dt_j * a over the chunk's Q positions and
// dts[j] = dt_j, computed by one warp: each lane sums a run of consecutive
// positions, and a warp scan adds the runs before it.
__device__ void chunk_cumsum(const float* __restrict__ dt, float a, int Q,
                             float* cs, float* dts) {
  const int lane = threadIdx.x & 31;
  const int per = (Q + 31) / 32;
  const int j0 = lane * per;
  float run = 0.f;
  for (int k = 0; k < per; ++k) {
    const int j = j0 + k;
    if (j < Q) {
      const float d = dt[j];
      dts[j] = d;
      run += __fmul_rn(d, a);   // dA = dt * A rounded, as the reference forms it
      cs[j] = run;
    }
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  for (int k = 0; k < per; ++k) {
    const int j = j0 + k;
    if (j < Q) cs[j] += before;
  }
}

// acc[a][b] += sum_jj GT[jj][row a] X[jj][col b] over one step, for this
// thread's 4 rows (tr * 4 + a) and P / 16 consecutive columns
// (tc * P / 16 + b).  The weights are stored transposed, so a thread's 4
// rows are one 16-byte load, and its columns one 16-, 8- or 4-byte load:
// two shared-memory loads feed 4 P / 16 multiply-adds.
template <int P>
__device__ __forceinline__ void accumulate(const float* GT, const float* X, int tr, int tc,
                                           float (&acc)[4][P / 16]) {
  constexpr int kC = P / 16;
#pragma unroll 4
  for (int jj = 0; jj < kStep; ++jj) {
    const float4 g4 = *reinterpret_cast<const float4*>(GT + jj * kLdT + tr * 4);
    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
    float xv[kC];
    const float* xr = X + jj * P + tc * kC;
    if constexpr (kC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(xr);
      xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
    } else if constexpr (kC == 2) {
      const float2 v = *reinterpret_cast<const float2*>(xr);
      xv[0] = v.x; xv[1] = v.y;
    } else {
      xv[0] = xr[0];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kC; ++b) acc[a][b] += g[a] * xv[b];
  }
}

// X[jj][p] = w[j0 + jj] x[j0 + jj][p] of one head's [Q, P] slab (w = 1
// when null), zero past Q.
template <typename T, int P>
__device__ __forceinline__ void load_x(const T* __restrict__ xh, const float* w, int j0,
                                       int Q, float* X) {
  for (int e = threadIdx.x; e < kStep * P; e += kThreads) {
    const int jj = e / P, p = e % P, j = j0 + jj;
    float v = 0.f;
    if (j < Q) {
      v = to_f32(xh[static_cast<size_t>(j) * P + p]);
      if (w) v *= w[j];
    }
    X[e] = v;
  }
}

// out rows [r0, r0 + 64) x P of one head from this thread's accumulators.
template <int P>
__device__ __forceinline__ void store_rows(float* __restrict__ out, int r0, int rows,
                                           int tr, int tc, const float (&acc)[4][P / 16]) {
  constexpr int kC = P / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + tr * 4 + a;
    if (r >= rows) continue;
#pragma unroll
    for (int b = 0; b < kC; ++b) out[static_cast<size_t>(r) * P + tc * kC + b] = acc[a][b];
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_y(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
      const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y, int H,
      int Q, int N) {
  __shared__ float cs[kHeads][kMaxQ];
  __shared__ float dts[kHeads][kMaxQ];
  extern __shared__ __align__(16) float smem[];
  const int ldn = N + 1;
  float* GT = smem;                       // [kStep][kLdT]  one head's weights
  float* X = GT + kStep * kLdT;           // [kStep][P]     one head's x rows
  float* CT = X + kStep * P;              // [N][kLdT]      the tile's C rows, transposed
  float* Bs = CT + N * kLdT;              // [kStep][ldn]   the step's B rows

  const int c = blockIdx.x, i0 = blockIdx.y * kRows, h0 = blockIdx.z * kHeads;
  const int nh = min(kHeads, H - h0);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int warp = tid / 32;
  if (warp < nh)
    chunk_cumsum(dt + (static_cast<size_t>(c) * H + h0 + warp) * Q, A[h0 + warp], Q,
                 cs[warp], dts[warp]);
  const T* Cc = Cm + static_cast<size_t>(c) * Q * N;
  const T* Bc = Bm + static_cast<size_t>(c) * Q * N;
  for (int e = tid; e < kRows * N; e += kThreads) {
    const int r = e / N, n = e % N, i = i0 + r;
    CT[n * kLdT + r] = i < Q ? to_f32(Cc[static_cast<size_t>(i) * N + n]) : 0.f;
  }
  // this thread's 4 x 2 piece of each step's C B^T tile: rows r0..r0+3,
  // columns c0, c0+1 (a warp: 16 row groups, 2 column pairs)
  const int r0 = (tid % 16) * 4, c0 = (tid / 16) * 2;

  float acc[kHeads][4][P / 16] = {};
  const int i_end = min(i0 + kRows, Q);
  for (int j0 = 0; j0 < i_end; j0 += kStep) {
    __syncthreads();  // the last step's readers of Bs, GT and X are done
    for (int e = tid; e < kStep * N; e += kThreads) {
      const int jj = e / N, n = e % N, j = j0 + jj;
      Bs[jj * ldn + n] = j < Q ? to_f32(Bc[static_cast<size_t>(j) * N + n]) : 0.f;
    }
    __syncthreads();
    float cb[4][2] = {};
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(CT + n * kLdT + r0);
      const float b0 = Bs[c0 * ldn + n], b1 = Bs[(c0 + 1) * ldn + n];
      cb[0][0] += cv.x * b0; cb[1][0] += cv.y * b0; cb[2][0] += cv.z * b0; cb[3][0] += cv.w * b0;
      cb[0][1] += cv.x * b1; cb[1][1] += cv.y * b1; cb[2][1] += cv.z * b1; cb[3][1] += cv.w * b1;
    }
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh < nh) {  // uniform across the block
        __syncthreads();  // the last head's readers of GT and X are done
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int j = j0 + c0 + k;
          float g[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + r0 + a;
            g[a] = (j <= i && i < Q)
                       ? cb[a][k] * expf(cs[hh][i] - cs[hh][j]) * dts[hh][j]
                       : 0.f;
          }
          *reinterpret_cast<float4*>(GT + (c0 + k) * kLdT + r0) =
              make_float4(g[0], g[1], g[2], g[3]);
        }
        load_x<T, P>(x + (static_cast<size_t>(c) * H + h0 + hh) * Q * P, nullptr, j0, Q, X);
        __syncthreads();
        accumulate<P>(GT, X, tr, tc, acc[hh]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh)
    if (hh < nh)
      store_rows<P>(y + (static_cast<size_t>(c) * H + h0 + hh) * Q * P, i0, Q, tr, tc,
                    acc[hh]);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_states(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, float* __restrict__ states, int H, int Q, int N) {
  __shared__ float cs[kHeads][kMaxQ];
  __shared__ float dts[kHeads][kMaxQ];
  __shared__ float wts[kHeads][kMaxQ];               // exp(cs_last - cs_j) dt_j
  __shared__ __align__(16) float BT[kStep * kLdT];   // BT[jj][r] = B_{j0+jj}[n0+r]
  __shared__ __align__(16) float X[kStep * P];

  const int c = blockIdx.x, n0 = blockIdx.y * kRows, h0 = blockIdx.z * kHeads;
  const int nh = min(kHeads, H - h0);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int warp = tid / 32;
  if (warp < nh) {
    chunk_cumsum(dt + (static_cast<size_t>(c) * H + h0 + warp) * Q, A[h0 + warp], Q,
                 cs[warp], dts[warp]);
    __syncwarp();
    const float last = cs[warp][Q - 1];
    for (int j = tid % 32; j < Q; j += 32)
      wts[warp][j] = expf(last - cs[warp][j]) * dts[warp][j];
  }
  const T* Bc = Bm + static_cast<size_t>(c) * Q * N;

  float acc[kHeads][4][P / 16] = {};
  for (int j0 = 0; j0 < Q; j0 += kStep) {
    __syncthreads();  // wts is complete; the last step's readers of BT are done
    for (int e = tid; e < kStep * kRows; e += kThreads) {
      const int jj = e / kRows, r = e % kRows, j = j0 + jj, n = n0 + r;
      BT[jj * kLdT + r] = (j < Q && n < N) ? to_f32(Bc[static_cast<size_t>(j) * N + n]) : 0.f;
    }
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh < nh) {  // uniform across the block
        __syncthreads();  // BT is complete; the last head's readers of X are done
        load_x<T, P>(x + (static_cast<size_t>(c) * H + h0 + hh) * Q * P, wts[hh], j0, Q, X);
        __syncthreads();
        accumulate<P>(BT, X, tr, tc, acc[hh]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh)
    if (hh < nh)
      store_rows<P>(states + (static_cast<size_t>(c) * H + h0 + hh) * N * P, n0, N, tr, tc,
                    acc[hh]);
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* states, int nc, int H, int Q, int N,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kStep * kLdT + kStep * P + N * kLdT +
                                       kStep * (N + 1));
  cudaError_t err = allow_smem(ssd_y<T, P>, smem);
  if (err != cudaSuccess) return err;
  const int heads = (H + kHeads - 1) / kHeads;
  ssd_y<T, P><<<dim3(nc, (Q + kRows - 1) / kRows, heads), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y), H, Q, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_states<T, P><<<dim3(nc, (N + kRows - 1) / kRows, heads), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<float*>(states), H, Q, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(int P, const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, void* y, void* states, int nc, int H, int Q, int N,
                     cudaStream_t st) {
  // the head dims served: 16 (reduced), 32 (the reference's test), 64 (mamba2)
  switch (P) {
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, y, states, nc, H, Q, N, st);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, y, states, nc, H, Q, N, st);
    case 64: return launch<T, 64>(x, dt, A, Bm, Cm, y, states, nc, H, Q, N, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [nc,H,Q,P] and Bm/Cm [nc,Q,N] of `dtype`; dt [nc,H,Q] and A [H] f32;
// y [nc,H,Q,P] and states [nc,H,N,P] f32 out.  1 <= Q <= 256, 1 <= N <= 256,
// P one of 16, 32, 64.  All contiguous, all on the stream's device.  Returns
// the CUDA error code of the launches (0 on success).
extern "C" int ssd_chunk(int dtype, const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, void* y, void* states, int nc,
                         int H, int Q, int P, int N, void* stream) {
  if (nc <= 0 || H <= 0) return cudaSuccess;
  if (Q < 1 || Q > kMaxQ || N < 1 || N > 256) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(
        launch_p<float>(P, x, dt, A, Bm, Cm, y, states, nc, H, Q, N, st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(
        launch_p<__nv_bfloat16>(P, x, dt, A, Bm, Cm, y, states, nc, H, Q, N, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
