// Mamba-2 SSD inside each chunk (state-space duality, one B/C group): for
// every stacked chunk c and head h, with cs = cumsum(dt A) over the chunk,
//
//   y[i, :]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, :]
//   state    = sum_j B_j^T exp(cs_last - cs_j) dt_j x[j, :]      ([N, P])
//
// Replaces: src/repro/kernels/ssd_scan.py:64 ssd_chunk (the Pallas kernel
// _ssd_kernel, :31).  The port calls it from models/ssm.py ssd_chunked on
// every Mamba-2 prefill, once per layer, with the chunks of the prompt
// stacked; the inter-chunk recurrence stays in PyTorch.  One call is one
// launch, of the route the wrapper names (kernels/ssd_scan.py route).
//
// The tensor-core route (ROUTE_MMA: bf16 x, B and C at P = 64, N <= 256, a
// multiple of 8 — mamba2's prefill).  The work of a chunk and head is a
// flash-attention tile: S = C B^T (Q x Q over N), G' = S exp(cs_i - cs_j)
// dt_j below the diagonal, y = G' x (Q x P over Q), and states =
// (B o w)^T x (N x P over Q, w_j = exp(cs_last - cs_j) dt_j).  Every
// product has one operand exact in bf16: C B^T both (exact products, f32
// sums on the tensor cores); in the other two x, while G' and B o w are
// f32.  Each f32 operand is split into three bf16 pieces, hi = bf16(v),
// mid = bf16(v - hi), lo = bf16(v - hi - mid), which hold all 24 bits of
// v, and the three products are summed into the same f32 accumulators
// (mma.sync m16n8k16): the reference's f32 arithmetic on the tensor cores
// (TF32 would keep 10 bits).  Folding dt into G' reassociates the
// reference's x dt; chip_smoke.py's ssd_tolerance covers that.
//
// What bounds it on the H100: bytes, once the products run on the tensor
// cores.  Per chunk and head: about 3 Q^2 P / 2 + 3 Q N P bf16
// multiply-adds (the split triples them; C B^T is shared by the heads of a
// block) against the f32 outputs' 4 (Q P + N P) bytes; at mamba2's shape
// (Q = 256, P = 64, N = 128) the outputs alone are ~250 MB an 8192-token
// prompt, and the exps (Q^2 / 2 a head) run on the MUFU beside them.
//
// Layout.  A block is 4 warps and serves two heads of one chunk (every C
// B^T tile feeds both) and one 64-row block of outputs: either query rows
// i (y blocks, which walk the key tiles up to their diagonal, heaviest
// launched first) or state rows n (state blocks, which walk every key
// tile).  Each warp owns 16 output rows of both heads, their accumulators
// in registers.  Key tiles of 64 positions (B's rows — all N columns for
// a y block, the block's 64 for a state block — and both heads' x rows)
// stream through a 2-stage ring of 16-byte cp.async copies, the y block's
// 64 C rows staged once beside it; rows past Q and columns past N are
// zero-filled, never read.  y: per 16-key step a warp forms its 16 x 16
// tile of C B^T from ldmatrix'ed C and B rows (skipped above the
// diagonal), turns it in registers into G' for each head (exp only at and
// below the diagonal: above it cs_i - cs_j can be positive and overflow)
// and, split, into the A operand of G' x, whose B operand is the head's x
// rows (ldmatrix.trans).  states: the A operand is B^T of the warp's 16
// state rows (ldmatrix.trans), scaled by the head's w and split.  Each
// block computes its heads' cumulative sums itself (one warp a head).
//
// The tile route (ROUTE_TILE: f32, P of 16 or 32, any other input): two
// launches of CUDA-core kernels in f32.  Pass 1 (ssd_y) computes a 64-row
// output tile for up to 4 heads (kHeads, the TPU kernel's head block), so
// that every C B^T tile it builds serves all of them: rows are query
// positions i, walking the key positions j <= the tile's last row in
// 32-row steps.  Each step builds the 64 x 32 tile of C B^T in registers
// (4 x 2 a thread) from the tile's C rows (kept transposed in shared
// memory for the whole walk) and the step's B rows; then, per head, it
// forms the weights G = CB exp(cs_i - cs_j) dt_j (exp only where j <= i),
// stores them beside the step's x rows, and adds G x into registers.
// Pass 2 (ssd_states): rows are state positions n, the weights are B
// itself, shared by the heads, and each head's x rows are scaled by
// exp(cs_last - cs_j) dt_j (Q exps a head); the walk covers every j.  Each
// thread keeps a 4 x P/16 tile per head, fed by 16-byte shared-memory
// loads.  Both outputs are f32 on either route.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "mma_sync.cuh"

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

// two blocks an SM: at P = 16 ptxas otherwise caps the registers lower and
// spills
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
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

// ---------------------------------------------------------------------------
// The tensor-core route
// ---------------------------------------------------------------------------

namespace mma_route {

constexpr int kThreads = 128;  // 4 warps of 16 output rows
constexpr int kRows = 64;      // output rows a block: query rows i or state rows n
constexpr int kTile = 32;      // key positions j a ring stage
constexpr int kSteps = kTile / 16;  // 16-key steps a stage
constexpr int kHB = 2;         // heads a block: every C B^T tile serves both
constexpr int kP = 64;         // the route's head dim
constexpr int kStages = 2;
constexpr int kMaxN = 256;

// byte offset of 16-byte piece c of row r in a tile of `pieces` pieces a
// row (a multiple of 8): the piece index xor-ed with the row, so the 8 rows
// an ldmatrix reads fall in 8 distinct bank groups
__device__ __forceinline__ int at(int r, int c, int pieces) {
  return (r * pieces + (c ^ (r & 7))) * 16;
}

// (v0, v1) = hi + mid + lo, each a bf16 pair (v0 in the low half):
// hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), 24 bits in all
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  float r0 = v0 - bf16_lo(hi), r1 = v1 - bf16_hi(hi);
  mid = pack_bf16(r0, r1);
  r0 -= bf16_lo(mid);
  r1 -= bf16_hi(mid);
  lo = pack_bf16(r0, r1);
}

// acc[8 column blocks of x] += (hi + mid + lo) x over the 16 keys of step
// kk: A the split operand (rows: the warp's 16 outputs), B the head's x
// rows of the step from the stage (xt: [kTile][kP] bf16), by ldmatrix.trans
__device__ __forceinline__ void product(float (&acc)[8][4], const uint32_t (&hi)[4],
                                        const uint32_t (&mid)[4], const uint32_t (&lo)[4],
                                        const unsigned char* xt, int kk, int lane) {
  uint32_t xb[4][4];
  const int r = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) ldsm_x4_t(xb[pp], xt + at(r, 2 * pp + (lane >> 4), 8));
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    mma_16816(acc[2 * pp], hi, xb[pp][0], xb[pp][1]);
    mma_16816(acc[2 * pp + 1], hi, xb[pp][2], xb[pp][3]);
  }
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    mma_16816(acc[2 * pp], mid, xb[pp][0], xb[pp][1]);
    mma_16816(acc[2 * pp + 1], mid, xb[pp][2], xb[pp][3]);
  }
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    mma_16816(acc[2 * pp], lo, xb[pp][0], xb[pp][1]);
    mma_16816(acc[2 * pp + 1], lo, xb[pp][2], xb[pp][3]);
  }
}

struct Params {
  const __nv_bfloat16* x;   // [nc, H, Q, kP]
  const float* dt;          // [nc, H, Q]
  const float* A;           // [H]
  const __nv_bfloat16* Bm;  // [nc, Q, N]
  const __nv_bfloat16* Cm;  // [nc, Q, N]
  float* y;                 // [nc, H, Q, kP]
  float* states;            // [nc, H, N, kP]
  int H, Q, N;
  int Ns;                   // staged row width of B and C: N up to a multiple of 64
  int Nk;                   // N up to a multiple of 16: the C B^T product's depth
  int n_hp, n_y, n_s;       // head pairs; y and state row blocks
};

__host__ __device__ constexpr int stage_bytes(int Ns) {
  return kTile * Ns * 2 + kHB * kTile * kP * 2;
}

__global__ void __launch_bounds__(kThreads) ssd_mma(const Params p) {
  __shared__ __align__(16) float cs[kHB][kMaxQ];
  __shared__ __align__(16) float dts[kHB][kMaxQ];
  __shared__ __align__(16) float wts[kHB][kMaxQ];   // exp(cs_last - cs_j) dt_j
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, Q = p.Q, N = p.N, Ns = p.Ns;
  const int roles = p.n_y + p.n_s;
  const int unit = blockIdx.x / roles, role = blockIdx.x % roles;
  const int c = unit / p.n_hp, h0 = (unit % p.n_hp) * kHB;
  const int nh = min(kHB, H - h0);
  const bool is_y = role < p.n_y;
  const int rb = is_y ? p.n_y - 1 - role : role - p.n_y;  // the block's row block
  const int r0 = rb * kRows;
  // y: the key tiles up to the block's last row; states: every key tile
  const int n_tiles = is_y ? min(r0 + kRows, Q) / kTile + (min(r0 + kRows, Q) % kTile != 0)
                           : (Q + kTile - 1) / kTile;
  const int bp = is_y ? Ns / 8 : kRows / 8;  // staged pieces of a B row
  const int bc0 = is_y ? 0 : r0;             // B's first staged column

  unsigned char* Cs = smem;                  // y blocks: [kRows][Ns] C rows r0 ...
  unsigned char* ring = smem + kRows * Ns * 2;
  const __nv_bfloat16* Bc = p.Bm + static_cast<size_t>(c) * Q * N;
  const __nv_bfloat16* Cc = p.Cm + static_cast<size_t>(c) * Q * N;
  const __nv_bfloat16* xc = p.x + (static_cast<size_t>(c) * H + h0) * Q * kP;

  // key tile s into stage s % kStages: B rows (bp pieces from column bc0),
  // then each head's x rows; zeros past Q and N
  auto issue = [&](int s) {
    unsigned char* st = ring + (s % kStages) * stage_bytes(Ns);
    unsigned char* xs = st + kTile * Ns * 2;
    const int j0 = s * kTile;
    for (int e = tid; e < kTile * bp; e += kThreads) {
      const int r = e / bp, q = e % bp, j = j0 + r, col = bc0 + 8 * q;
      const bool ok = j < Q && col < N;
      cp_async16(st + at(r, q, bp), Bc + (ok ? static_cast<size_t>(j) * N + col : 0),
                 ok ? 16 : 0);
    }
    for (int e = tid; e < nh * kTile * 8; e += kThreads) {
      const int hh = e / (kTile * 8), r = (e / 8) % kTile, q = e % 8, j = j0 + r;
      const bool ok = j < Q;
      cp_async16(xs + hh * kTile * kP * 2 + at(r, q, 8),
                 xc + (ok ? (static_cast<size_t>(hh) * Q + j) * kP + 8 * q : 0), ok ? 16 : 0);
    }
  };
  if (is_y) {
    const int cp = Ns / 8;
    for (int e = tid; e < kRows * cp; e += kThreads) {
      const int r = e / cp, q = e % cp, i = r0 + r, col = 8 * q;
      const bool ok = i < Q && col < N;
      cp_async16(Cs + at(r, q, cp), Cc + (ok ? static_cast<size_t>(i) * N + col : 0),
                 ok ? 16 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // the heads' cumulative sums, one warp a head, and zeros past Q
  if (warp < nh) {
    chunk_cumsum(p.dt + (static_cast<size_t>(c) * H + h0 + warp) * Q, p.A[h0 + warp], Q,
                 cs[warp], dts[warp]);
    __syncwarp();
    const float last = cs[warp][Q - 1];
    for (int j = lane; j < kMaxQ; j += 32) {
      if (j < Q) {
        if (!is_y) wts[warp][j] = __fmul_rn(expf(last - cs[warp][j]), dts[warp][j]);
      } else {
        cs[warp][j] = 0.f;
        dts[warp][j] = 0.f;
        wts[warp][j] = 0.f;
      }
    }
  }

  float acc[kHB][8][4];
#pragma unroll
  for (int hh = 0; hh < kHB; ++hh)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) acc[hh][nb][0] = acc[hh][nb][1] = acc[hh][nb][2] =
        acc[hh][nb][3] = 0.f;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const int w0 = r0 + 16 * warp;             // the warp's first output row
  const bool rows_in = w0 < (is_y ? Q : N);
  const int i_a = w0 + g, i_b = i_a + 8;     // y: the lane's two query rows

#pragma unroll 1
  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<kStages - 1>();  // key tile s has landed (this thread's copies)
    __syncthreads();               // and every thread's; the sums are done
    const unsigned char* st = ring + (s % kStages) * stage_bytes(Ns);
    const unsigned char* xs = st + kTile * Ns * 2;
    const int j0 = s * kTile;
    if (rows_in && is_y) {
      // 16-key steps with a key at or below some row of the warp
      const int last = min(w0 + 15, Q - 1);
      const int kk_end = last < j0 ? 0 : min(kSteps, (last - j0) / 16 + 1);
      float cb[2 * kSteps][4];
#pragma unroll
      for (int nb = 0; nb < 2 * kSteps; ++nb) cb[nb][0] = cb[nb][1] = cb[nb][2] = cb[nb][3] = 0.f;
      const int cp = Ns / 8;
      const int rc = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll 1
      for (int ks = 0; ks < p.Nk / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, Cs + at(rc, 2 * ks + (lane >> 4), cp));
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          if (kk < kk_end) {
            uint32_t b[4];
            ldsm_x4(b, st + at(16 * kk + (lane & 7) + 8 * (lane >> 4),
                               2 * ks + ((lane >> 3) & 1), cp));
            mma_16816(cb[2 * kk], a, b[0], b[1]);
            mma_16816(cb[2 * kk + 1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (kk < kk_end) {
#pragma unroll
          for (int hh = 0; hh < kHB; ++hh) {
            if (hh < nh) {
              const float csa = i_a < Q ? cs[hh][i_a] : 0.f;
              const float csb = i_b < Q ? cs[hh][i_b] : 0.f;
              float gv[2][4];
#pragma unroll
              for (int nb = 0; nb < 2; ++nb) {
                const int j = j0 + 16 * kk + 8 * nb + q2;
                const float2 cj = *reinterpret_cast<const float2*>(&cs[hh][j]);
                const float2 dj = *reinterpret_cast<const float2*>(&dts[hh][j]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int i = e < 2 ? i_a : i_b, jj = j + (e & 1);
                  const float d = (jj <= i && i < Q)
                                      ? (e < 2 ? csa : csb) - ((e & 1) ? cj.y : cj.x)
                                      : NEG_INF;
                  gv[nb][e] = __fmul_rn(__fmul_rn(cb[2 * kk + nb][e], expf(d)),
                                        (e & 1) ? dj.y : dj.x);
                }
              }
              uint32_t hi[4], mid[4], lo[4];
              split3(gv[0][0], gv[0][1], hi[0], mid[0], lo[0]);  // row g, keys q2, q2 + 1
              split3(gv[0][2], gv[0][3], hi[1], mid[1], lo[1]);  // row g + 8
              split3(gv[1][0], gv[1][1], hi[2], mid[2], lo[2]);  // row g, keys + 8
              split3(gv[1][2], gv[1][3], hi[3], mid[3], lo[3]);  // row g + 8, keys + 8
              product(acc[hh], hi, mid, lo, xs + hh * kTile * kP * 2, kk, lane);
            }
          }
        }
      }
    } else if (rows_in) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int jb = j0 + 16 * kk;
        if (jb < Q) {
          // B^T of the warp's 16 state rows over the step's 16 keys
          uint32_t bt[4];
          ldsm_x4_t(bt, st + at(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                2 * warp + ((lane >> 3) & 1), 8));
#pragma unroll
          for (int hh = 0; hh < kHB; ++hh) {
            if (hh < nh) {
              const float2 wa = *reinterpret_cast<const float2*>(&wts[hh][jb + q2]);
              const float2 wb = *reinterpret_cast<const float2*>(&wts[hh][jb + 8 + q2]);
              uint32_t hi[4], mid[4], lo[4];
              split3(__fmul_rn(bf16_lo(bt[0]), wa.x), __fmul_rn(bf16_hi(bt[0]), wa.y), hi[0],
                     mid[0], lo[0]);
              split3(__fmul_rn(bf16_lo(bt[1]), wa.x), __fmul_rn(bf16_hi(bt[1]), wa.y), hi[1],
                     mid[1], lo[1]);
              split3(__fmul_rn(bf16_lo(bt[2]), wb.x), __fmul_rn(bf16_hi(bt[2]), wb.y), hi[2],
                     mid[2], lo[2]);
              split3(__fmul_rn(bf16_lo(bt[3]), wb.x), __fmul_rn(bf16_hi(bt[3]), wb.y), hi[3],
                     mid[3], lo[3]);
              product(acc[hh], hi, mid, lo, xs + hh * kTile * kP * 2, kk, lane);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage s % kStages
    if (s + kStages < n_tiles) issue(s + kStages);
    cp_async_commit();
  }

  if (!rows_in) return;
  const int lim = is_y ? Q : N;
#pragma unroll
  for (int hh = 0; hh < kHB; ++hh) {
    if (hh < nh) {
      const size_t head = static_cast<size_t>(c) * H + h0 + hh;
      float* out = is_y ? p.y + head * Q * kP : p.states + head * N * kP;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = 8 * nb + q2;
        if (w0 + g < lim)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(w0 + g) * kP + col) =
              make_float2(acc[hh][nb][0], acc[hh][nb][1]);
        if (w0 + g + 8 < lim)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(w0 + g + 8) * kP + col) =
              make_float2(acc[hh][nb][2], acc[hh][nb][3]);
      }
    }
  }
}

// Refuses what the route cannot take: N not a multiple of 8 (B and C rows
// are staged in 16-byte pieces) or above kMaxN, and x, B or C not 16-byte
// aligned.
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, void* y, void* states, int nc, int H, int Q, int N,
                   cudaStream_t stream) {
  if (N % 8 != 0 || N > kMaxN || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(Bm) % 16 != 0 || reinterpret_cast<uintptr_t>(Cm) % 16 != 0)
    return cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(x),
           static_cast<const float*>(dt),
           static_cast<const float*>(A),
           static_cast<const __nv_bfloat16*>(Bm),
           static_cast<const __nv_bfloat16*>(Cm),
           static_cast<float*>(y),
           static_cast<float*>(states),
           H,
           Q,
           N,
           (N + 63) / 64 * 64,
           (N + 15) / 16 * 16,
           (H + kHB - 1) / kHB,
           (Q + kRows - 1) / kRows,
           (N + kRows - 1) / kRows};
  const long long blocks = static_cast<long long>(nc) * p.n_hp * (p.n_y + p.n_s);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kRows) * p.Ns * 2 + kStages * stage_bytes(p.Ns);
  // with the static arrays the block needs more than the default 48 KB
  // whatever the dynamic part
  cudaError_t err = cudaFuncSetAttribute(ssd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_mma<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mma_route

}  // namespace

// B7's tensor-core route (mma.sync) is passed the tensor-core route code
constexpr int ROUTE_MMA = ROUTE_WGMMA;

// x [nc,H,Q,P] and Bm/Cm [nc,Q,N] of `dtype`; dt [nc,H,Q] and A [H] f32;
// y [nc,H,Q,P] and states [nc,H,N,P] f32 out.  1 <= Q <= 256, 1 <= N <= 256;
// `route` ROUTE_MMA (bf16, P = 64, N a multiple of 8, x, B and C 16-byte
// aligned) or ROUTE_TILE (P one of 16, 32, 64).  All contiguous, all on the
// stream's device.  Returns the CUDA error code of the launches (0 on
// success); a route the inputs do not fit is refused (nothing launched).
extern "C" int ssd_chunk(int dtype, int route, const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, void* y, void* states, int nc,
                         int H, int Q, int P, int N, void* stream) {
  if (nc <= 0 || H <= 0) return cudaSuccess;
  if (Q < 1 || Q > kMaxQ || N < 1 || N > 256) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_MMA) {
    if (dtype != DTYPE_BF16 || P != mma_route::kP) return cudaErrorInvalidValue;
    return static_cast<int>(mma_route::launch(x, dt, A, Bm, Cm, y, states, nc, H, Q, N, st));
  }
  if (route != ROUTE_TILE) return cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return static_cast<int>(
        launch_p<float>(P, x, dt, A, Bm, Cm, y, states, nc, H, Q, N, st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(
        launch_p<__nv_bfloat16>(P, x, dt, A, Bm, Cm, y, states, nc, H, Q, N, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
