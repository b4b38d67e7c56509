// Paged flash-decode: one new query token per sequence against the shared
// KV page pool, gathered through per-sequence block tables.
//
// Replaces: src/repro/kernels/decode_attention.py:186 paged_decode_attention
// (the Pallas kernel _paged_decode_kernel), called on every paged decode
// step of every layer (src/repro/models/attention.py:958).
//
// What bounds it on the H100: bytes.  A decode step reads every live K/V
// row of the batch once and does 4*D flops per row and query head, far
// below the ~295 flops per byte at which the tensor cores would bind.
//
// Layout, in two passes (split-K "flash-decoding"):
//
// 1. paged_decode_partial — one block per (sequence b, kv head h, split z
//    of `split` tokens).  At the paper's low batch B * Hkv is only 8-32, so
//    one block per (b, h) would leave most of the 132 SMs idle and every
//    block waiting on memory latency; splitting each sequence's walk over
//    many blocks is what keeps enough loads in flight.  A block holds the G
//    query heads of its GQA group (H / Hkv), so each K/V row is read from
//    device memory once for all G heads.  It walks its split in steps of
//    kTok tokens: all threads stage the step's K and V rows into shared
//    memory together (kBatch loads in flight per thread), then compute the
//    scores, one online-softmax update per head in f32 (scale 1/sqrt(D)),
//    and P.V out of shared memory.  A token is valid iff it lies before
//    lengths[b] on a page whose table entry is allocated (< n_pages);
//    invalid tokens are never loaded (their staged rows are zero and their
//    p is 0), so a non-finite value on a masked row or a sentinel page
//    cannot reach the output.  p is rounded to the value dtype before P.V,
//    as the reference does.  The split's running max m, denominator l and
//    unnormalised accumulator go to f32 scratch.
// 2. paged_decode_combine (paged_decode_combine.cuh) — one block per
//    (b, h): rescales the splits that hold tokens to their common max,
//    sums, divides by l (clamped at 1e-30) and writes the result in q's
//    dtype.
//
// CUDA-core FMAs out of shared memory; wgmma/TMA are not needed to reach
// the byte bound of a one-token query, but a persistent, pipelined walk is
// the next step for this kernel.
#include "common.cuh"
#include "paged_decode_combine.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTok = 32;     // tokens staged per step
constexpr int kBatch = 8;    // loads in flight per thread while staging

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
paged_decode_partial(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages, const int* __restrict__ bt,
                     const int* __restrict__ lengths, float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int H, int Hkv, int n_pages,
                     int P, int W, int split, float scale) {
  constexpr int kDp = kD + 1;           // padded K rows: no bank conflicts
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int G = H / Hkv;
  const int len = min(lengths[b], W * P);
  const int t_begin = z * split;
  if (t_begin >= len) return;           // the combine pass skips this split
  const int t_end = min(t_begin + split, len);

  extern __shared__ float smem[];
  float* q_s = smem;                    // [G][kD] query heads of the group
  float* acc = q_s + G * kD;            // [G][kD] P.V accumulator
  float* k_s = acc + G * kD;            // [kTok][kDp] staged keys
  float* v_s = k_s + kTok * kDp;        // [kTok][kD] staged values
  float* sc = v_s + kTok * kD;          // [G][kTok] scores, then rounded p
  float* m_s = sc + G * kTok;           // [G] running max
  float* l_s = m_s + G;                 // [G] running denominator
  float* c_s = l_s + G;                 // [G] this step's correction
  int* row_of = reinterpret_cast<int*>(c_s + G);  // [kTok] pool row, -1 = invalid
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = kThreads >> 5;

  for (int i = tid; i < G * kD; i += kThreads) {
    q_s[i] = to_f32(q[(static_cast<size_t>(b) * H + h * G) * kD + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  const size_t row = static_cast<size_t>(Hkv) * kD;   // token stride in a page
  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    // which pool row each token of the step lives in (page * P + offset)
    for (int j = tid; j < kTok; j += kThreads) {
      const int t = t0 + j;
      int r = -1;
      if (t < t_end) {
        const int page = bt[static_cast<size_t>(b) * W + t / P];
        if (page >= 0 && page < n_pages) r = page * P + t % P;
      }
      row_of[j] = r;
    }
    __syncthreads();

    // stage the step's K and V rows of this kv head (zeros where invalid):
    // kBatch loads per thread are issued before any is stored, so the
    // memory latency overlaps instead of adding up row after row
#pragma unroll
    for (int base = 0; base < kTok * kD; base += kBatch * kThreads) {
      float kx[kBatch], vx[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        kx[u] = 0.f;
        vx[u] = 0.f;
        if (i < kTok * kD) {
          const int r = row_of[i / kD];
          if (r >= 0) {
            const size_t at = static_cast<size_t>(r) * row +
                              static_cast<size_t>(h) * kD + i % kD;
            kx[u] = to_f32(k_pages[at]);
            vx[u] = to_f32(v_pages[at]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < kTok * kD) {
          k_s[(i / kD) * kDp + i % kD] = kx[u];
          v_s[i] = vx[u];
        }
      }
    }
    __syncthreads();

    // scores: one (head, token) pair per thread, four partial sums
    for (int i = tid; i < G * kTok; i += kThreads) {
      const int g = i / kTok, j = i % kTok;
      float s = NEG_INF;
      if (row_of[j] >= 0) {
        const float* qg = q_s + g * kD;
        const float* kj = k_s + j * kDp;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int d = 0; d < kD; d += 4) {
          a0 += qg[d] * kj[d];
          a1 += qg[d + 1] * kj[d + 1];
          a2 += qg[d + 2] * kj[d + 2];
          a3 += qg[d + 3] * kj[d + 3];
        }
        s = ((a0 + a1) + (a2 + a3)) * scale;
      }
      sc[i] = s;
    }
    __syncthreads();

    // online-softmax step per head, in f32, one warp per head (lanes over
    // the step's tokens); invalid tokens get p = 0
    for (int g = warp; g < G; g += n_warps) {
      float* sg = sc + g * kTok;
      float mx = NEG_INF;
      for (int j = lane; j < kTok; j += 32)
        if (row_of[j] >= 0) mx = fmaxf(mx, sg[j]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_s[g], mx);
      float sum = 0.f;
      for (int j = lane; j < kTok; j += 32) {
        float p = 0.f;
        if (row_of[j] >= 0) p = expf(sg[j] - m_new);
        sum += p;
        sg[j] = round_to<T>(p);
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_s[g] - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // P.V out of shared memory
    for (int i = tid; i < G * kD; i += kThreads) {
      const int g = i / kD, d = i % kD;
      const float* pg = sc + g * kTok;
      float a = acc[i] * c_s[g];
#pragma unroll
      for (int j = 0; j < kTok; ++j) a += pg[j] * v_s[j * kD + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  // this split's partial state: acc unnormalised, (m, l) per head
  const int n_split = gridDim.z;
  const size_t at = (static_cast<size_t>(b) * Hkv + h) * n_split + z;
  for (int i = tid; i < G * kD; i += kThreads) part_acc[at * G * kD + i] = acc[i];
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(at * G + g) * 2] = m_s[g];
    part_ml[(at * G + g) * 2 + 1] = l_s[g];
  }
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bt,
                   const void* lengths, void* out, void* part_acc, void* part_ml,
                   int B, int H, int Hkv, int n_pages, int P, int W, int split,
                   int n_split, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem =
      static_cast<size_t>(2 * G * kD + kTok * (kD + 1) + kTok * kD + G * kTok + 3 * G) *
          sizeof(float) + kTok * sizeof(int);
  cudaError_t err = allow_smem(paged_decode_partial<T, kD>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_partial<T, kD><<<dim3(B, Hkv, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(lengths),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, Hkv, n_pages, P,
      W, split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine<T><<<dim3(B, Hkv), kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, kD, P, W, split,
      n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* bt,
                     const void* lengths, void* out, void* part_acc, void* part_ml,
                     int B, int H, int Hkv, int n_pages, int P, int W, int split,
                     int n_split, float scale, cudaStream_t st) {
  // the head dims of the configurations served: 16 (reduced), 128 (full)
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, bt, lengths, out, part_acc, part_ml, B, H, Hkv,
                           n_pages, P, W, split, n_split, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, bt, lengths, out, part_acc, part_ml, B, H, Hkv,
                            n_pages, P, W, split, n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D]; k_pages/v_pages [n_pages,P,Hkv,D]; bt [B,W] int32;
// lengths [B] int32; out [B,H,D]; part_acc [B,Hkv,n_split,G,D] and part_ml
// [B,Hkv,n_split,G,2] f32 scratch, n_split = ceil(W*P / split), split a
// multiple of 32 tokens; D 16 or 128.  All contiguous, all
// on the stream's device.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pages,
                                      const void* v_pages, const void* bt,
                                      const void* lengths, void* out, void* part_acc,
                                      void* part_ml, int B, int H, int Hkv, int D,
                                      int n_pages, int P, int W, int split,
                                      int n_split, float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || P <= 0 || W <= 0 || n_pages <= 0 ||
      split <= 0 || split % kTok != 0 || n_split != (W * P + split - 1) / split)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch_d<float>(D, q, k_pages, v_pages, bt, lengths, out,
                                            part_acc, part_ml, B, H, Hkv, n_pages, P,
                                            W, split, n_split, scale, st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_d<__nv_bfloat16>(D, q, k_pages, v_pages, bt, lengths,
                                                    out, part_acc, part_ml, B, H, Hkv,
                                                    n_pages, P, W, split, n_split, scale,
                                                    st));
  return static_cast<int>(cudaErrorInvalidValue);
}
