// Paged flash-decode over packed-int4 KV pages: one new query token per
// sequence against a pool of uint8 nibble pairs plus per-(token, kv head)
// f32 scale pages, gathered through per-sequence block tables.
//
// Replaces: src/repro/kernels/decode_attention.py:313
// paged_decode_attention_q4 (the Pallas kernel _paged_decode_q4_kernel),
// called on every decode step of every layer when kv_dtype="int4"
// (src/repro/models/attention.py:1071).
//
// What bounds it on the H100: bytes.  A decode step reads, per live token
// and kv head, D/2 packed bytes and one 4-byte scale for K and again for V
// (a quarter of bf16's bytes at D = 128, plus the scales), and does 4*D
// flops per token and query head — far below the tensor cores' balance.
//
// Layout: the split-K layout of paged_decode_attention.cu (B1), with the
// unpacking in registers:
//
// 1. paged_decode_q4_partial — one block per (sequence b, kv head h, split
//    z of `split` tokens); the block holds the G query heads of its GQA
//    group, so every packed K/V row is read once for all of them.  It walks
//    its split in steps of kTok tokens: each thread loads 4-byte words (8
//    nibbles) of the step's K and V rows, unpacks them — element 2i is the
//    low nibble of byte i, 2i+1 the high one, a nibble >= 8 is value - 16 —
//    multiplies by the row's scale and stages f32 values in shared memory.
//    Scores, the online softmax and P.V follow in f32 with scale 1/sqrt(D);
//    unlike B1, p stays f32 (the reference's q4 kernel keeps q, p and the
//    dequantized V in f32, decode_attention.py:279-305).  A token is valid
//    iff it lies before lengths[b] on a page whose table entry is allocated
//    (< n_pages); invalid rows are never loaded (staged as zero, p = 0).
// 2. paged_decode_combine (paged_decode_combine.cuh) — merges the splits,
//    clamps l at 1e-30 and writes q's dtype.
#include <cstdint>

#include "common.cuh"
#include "paged_decode_combine.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTok = 32;     // tokens staged per step

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
paged_decode_q4_partial(const T* __restrict__ q, const uint32_t* __restrict__ k_pages,
                        const float* __restrict__ k_scales,
                        const uint32_t* __restrict__ v_pages,
                        const float* __restrict__ v_scales, const int* __restrict__ bt,
                        const int* __restrict__ lengths, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int H, int Hkv, int n_pages, int P,
                        int W, int split, float scale) {
  constexpr int kDp = kD + 1;           // padded K rows: no bank conflicts
  constexpr int kWords = kD / 8;        // 4-byte words of one packed row
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int G = H / Hkv;
  const int len = min(lengths[b], W * P);
  const int t_begin = z * split;
  if (t_begin >= len) return;           // the combine pass skips this split
  const int t_end = min(t_begin + split, len);

  extern __shared__ float smem[];
  float* q_s = smem;                    // [G][kD] query heads of the group
  float* acc = q_s + G * kD;            // [G][kD] P.V accumulator
  float* k_s = acc + G * kD;            // [kTok][kDp] dequantized keys
  float* v_s = k_s + kTok * kDp;        // [kTok][kD] dequantized values
  float* sc = v_s + kTok * kD;          // [G][kTok] scores, then p
  float* m_s = sc + G * kTok;           // [G] running max
  float* l_s = m_s + G;                 // [G] running denominator
  float* c_s = l_s + G;                 // [G] this step's correction
  float* ks_s = c_s + G;                // [kTok] the step's K scales
  float* vs_s = ks_s + kTok;            // [kTok] the step's V scales
  int* row_of = reinterpret_cast<int*>(vs_s + kTok);  // [kTok] pool row, -1 = invalid
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

  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    // which pool row each token of the step lives in, and its two scales
    for (int j = tid; j < kTok; j += kThreads) {
      const int t = t0 + j;
      int r = -1;
      if (t < t_end) {
        const int page = bt[static_cast<size_t>(b) * W + t / P];
        if (page >= 0 && page < n_pages) r = page * P + t % P;
      }
      row_of[j] = r;
      const size_t at = static_cast<size_t>(r) * Hkv + h;
      ks_s[j] = r >= 0 ? k_scales[at] : 0.f;
      vs_s[j] = r >= 0 ? v_scales[at] : 0.f;
    }
    __syncthreads();

    // stage the step's K and V rows of this kv head, unpacked and scaled
    // (zeros where invalid): one 4-byte word = 8 elements per load
    for (int i = tid; i < kTok * kWords; i += kThreads) {
      const int j = i / kWords, c = i % kWords;
      const int r = row_of[j];
      uint32_t kw = 0u, vw = 0u;
      if (r >= 0) {
        const size_t at = (static_cast<size_t>(r) * Hkv + h) * kWords + c;
        kw = __ldg(k_pages + at);
        vw = __ldg(v_pages + at);
      }
      const float sk = ks_s[j], sv = vs_s[j];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // nibble e of the word is element 8c+e; the shift pair sign-extends
        const int kn = static_cast<int>(kw << (28 - 4 * e)) >> 28;
        const int vn = static_cast<int>(vw << (28 - 4 * e)) >> 28;
        k_s[j * kDp + c * 8 + e] = static_cast<float>(kn) * sk;
        v_s[j * kD + c * 8 + e] = static_cast<float>(vn) * sv;
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

    // online-softmax step per head, in f32, one warp per head; p stays f32
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
        sg[j] = p;
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
cudaError_t launch(const void* q, const void* k, const void* ks, const void* v,
                   const void* vs, const void* bt, const void* lengths, void* out,
                   void* part_acc, void* part_ml, int B, int H, int Hkv, int n_pages,
                   int P, int W, int split, int n_split, float scale,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem =
      static_cast<size_t>(2 * G * kD + kTok * (kD + 1) + kTok * kD + G * kTok + 3 * G +
                          2 * kTok) * sizeof(float) + kTok * sizeof(int);
  cudaError_t err = allow_smem(paged_decode_q4_partial<T, kD>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_q4_partial<T, kD><<<dim3(B, Hkv, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const uint32_t*>(k),
      static_cast<const float*>(ks), static_cast<const uint32_t*>(v),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, Hkv, n_pages, P, W, split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine<T><<<dim3(B, Hkv), kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, kD, P, W, split,
      n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* ks, const void* v,
                     const void* vs, const void* bt, const void* lengths, void* out,
                     void* part_acc, void* part_ml, int B, int H, int Hkv, int n_pages,
                     int P, int W, int split, int n_split, float scale,
                     cudaStream_t st) {
  // the head dims of the configurations served: 16 (reduced), 128 (full)
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, ks, v, vs, bt, lengths, out, part_acc, part_ml, B, H,
                           Hkv, n_pages, P, W, split, n_split, scale, st);
    case 128:
      return launch<T, 128>(q, k, ks, v, vs, bt, lengths, out, part_acc, part_ml, B, H,
                            Hkv, n_pages, P, W, split, n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D] (dtype DTYPE_F32/BF16); k_pages/v_pages [n_pages,P,Hkv,D/2]
// uint8 nibble pairs, 4-byte aligned; k_scales/v_scales [n_pages,P,Hkv] f32;
// bt [B,W] int32; lengths [B] int32; out [B,H,D] in q's dtype; part_acc
// [B,Hkv,n_split,G,D] and part_ml [B,Hkv,n_split,G,2] f32 scratch, n_split
// = ceil(W*P / split), split a multiple of 32 tokens; D 16 or 128.  All
// contiguous, all on the stream's device.  Returns the CUDA error code of
// the launches (0 on success).
extern "C" int paged_decode_attention_q4(int dtype, const void* q, const void* k_pages,
                                         const void* k_scales, const void* v_pages,
                                         const void* v_scales, const void* bt,
                                         const void* lengths, void* out, void* part_acc,
                                         void* part_ml, int B, int H, int Hkv, int D,
                                         int n_pages, int P, int W, int split,
                                         int n_split, float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || P <= 0 || W <= 0 || n_pages <= 0 || split <= 0 ||
      split % kTok != 0 || n_split != (W * P + split - 1) / split ||
      reinterpret_cast<uintptr_t>(k_pages) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch_d<float>(D, q, k_pages, k_scales, v_pages, v_scales,
                                            bt, lengths, out, part_acc, part_ml, B, H,
                                            Hkv, n_pages, P, W, split, n_split, scale,
                                            st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_d<__nv_bfloat16>(
        D, q, k_pages, k_scales, v_pages, v_scales, bt, lengths, out, part_acc, part_ml,
        B, H, Hkv, n_pages, P, W, split, n_split, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
