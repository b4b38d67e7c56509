// First pass of the split-K float decode kernels (paged_decode_attention.cu,
// decode_attention.cu): one block per (sequence b, kv head h, split z of
// `split` tokens) walks its split of one sequence's K/V and leaves the
// split's running max m, denominator l and unnormalised accumulator in f32
// scratch for the combine pass (paged_decode_combine.cuh).
//
// At the paper's low batch B * Hkv is only 8-32, so one block per (b, h)
// would leave most of the 132 SMs idle and every block waiting on memory
// latency; splitting each sequence's walk over many blocks is what keeps
// enough loads in flight.  A block holds the G query heads of its GQA
// group (H / Hkv), so each K/V row is read from device memory once for all
// G heads.  It walks its split in steps of kTok tokens: all threads stage
// the step's K and V rows into shared memory together (kBatch loads in
// flight per thread), then compute the scores, one online-softmax update
// per head in f32 (scale 1/sqrt(D)), and P.V out of shared memory.
//
// The caller's `locate(t)` names the cache row (token index into a
// [rows, Hkv, D] array) that holds logical token t of the sequence, or -1
// when t is not a valid key (an unallocated page).  Tokens at or past
// `len` are never located.  Invalid tokens are never loaded (their staged
// rows are zero and their p is 0), so a non-finite value on a masked row
// cannot reach the output.  p is rounded to the value dtype before P.V,
// as the reference does.
#pragma once

#include "common.cuh"

namespace decode_split {

constexpr int kThreads = 128;
constexpr int kTok = 32;     // tokens staged per step
constexpr int kBatch = 8;    // loads in flight per thread while staging

// dynamic shared memory of one block of `walk` for G heads
template <int kD>
inline size_t smem_bytes(int G) {
  return static_cast<size_t>(2 * G * kD + kTok * (kD + 1) + kTok * kD + G * kTok + 3 * G) *
             sizeof(float) + kTok * sizeof(int);
}

template <typename T, int kD, typename Locate>
__device__ __forceinline__ void walk(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, Locate locate, int len,
                                     float* __restrict__ part_acc,
                                     float* __restrict__ part_ml, int H, int Hkv,
                                     int split, float scale) {
  constexpr int kDp = kD + 1;           // padded K rows: no bank conflicts
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int G = H / Hkv;
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
  int* row_of = reinterpret_cast<int*>(c_s + G);  // [kTok] cache row, -1 = invalid
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

  const size_t row = static_cast<size_t>(Hkv) * kD;   // token stride
  for (int t0 = t_begin; t0 < t_end; t0 += kTok) {
    for (int j = tid; j < kTok; j += kThreads) {
      const int t = t0 + j;
      row_of[j] = t < t_end ? locate(t) : -1;
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
            kx[u] = to_f32(k[at]);
            vx[u] = to_f32(v[at]);
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

}  // namespace decode_split
