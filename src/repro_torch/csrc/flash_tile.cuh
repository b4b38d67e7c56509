// The register-tiled online-softmax step shared by the port's prefill
// attention kernels (packed_prefill_attention.cu, flash_attention.cu) on
// their CUDA-core route: f32 at any head dim (the tensor cores have no IEEE
// f32 mode) and bf16 at head dim 16 (the reduced configurations).  bf16 at
// head dim 64 and 128 takes flash_wgmma.cuh (wgmma, TMA-fed K/V stages).
//
// A block holds kRows query rows — BQ = kRows / G tokens x the G query
// heads of one GQA group — against one kv head, so each K/V row it stages
// serves all G heads.  The caller walks key tiles of kBK keys: it names
// each key's position (kpos, -1 = invalid) and its element offset in the
// key/value arrays (krow), then calls ``stage`` and ``update``.
//
// Each key tile is staged in shared memory with kBatch loads in flight per
// thread; each thread then computes a 2 x 4 block of the scores and keeps a
// 4-row x kD/16 block of the P.V accumulator in registers, so every value
// read from shared memory feeds several FMAs (shared-memory bandwidth, not
// the FMA units, is what binds a CUDA-core version).  A query at position
// q_pos sees a key at k_pos iff k_pos >= 0, k_pos <= q_pos when causal, and
// q_pos - k_pos < window when a window is set (flash_attention.py:56-60,
// :175-207).  Invalid keys load as zero rows and masked scores get p = 0,
// so no masked value is ever multiplied in.  Scores, the online softmax
// and P.V accumulate in f32; p is rounded to the value dtype before P.V;
// l is clamped at 1e-30.
#pragma once

#include "common.cuh"

namespace flash_tile {

constexpr int kRows = 64;     // (token, head) query rows per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 256;
constexpr int kBatch = 8;     // loads in flight per thread while staging

// dynamic shared memory of one block
template <int kD>
inline size_t smem_bytes() {
  return (static_cast<size_t>(kRows) * (kD + 1) + kBK * (kD + 1) + kBK * kD +
          kRows * (kBK + 1) + 3 * kRows) * sizeof(float) +
         kBK * (sizeof(long long) + sizeof(int));
}

__device__ __forceinline__ bool visible(int k_pos, int q_pos, int window, bool causal) {
  return k_pos >= 0 && (!causal || k_pos <= q_pos) &&
         (window <= 0 || q_pos - k_pos < window);
}

template <typename T, int kD>
struct Tile {
  static constexpr int kDp = kD + 1;     // padded rows: no bank conflicts
  static constexpr int kPs = kBK + 1;
  static constexpr int kDPer = kD / 16;  // accumulator columns per thread

  long long* krow;   // [kBK] element offset of each staged key row
  int* kpos;         // [kBK] positions, -1 = invalid
  float* q_s;        // [kRows][kDp]
  float* k_s;        // [kBK][kDp]
  float* v_s;        // [kBK][kD]
  float* p_s;        // [kRows][kPs] scores, then p
  float* m_s;        // [kRows] running max
  float* l_s;        // [kRows] running denominator
  float* c_s;        // [kRows] this tile's correction
  int tid;
  int pr0, pd0;      // this thread's P.V block: rows pr0..+3, cols pd0 + 16 u
  int sr0, sc0;      // its score block: rows sr0, sr0+1, cols sc0 + 8 u
  int xr, xc0;       // its softmax share: row xr, cols xc0..xc0+7
  float acc[4][kDPer];

  // carve the block's dynamic shared memory and reset the softmax state
  __device__ __forceinline__ explicit Tile(void* smem) {
    krow = static_cast<long long*>(smem);
    kpos = reinterpret_cast<int*>(krow + kBK);
    q_s = reinterpret_cast<float*>(kpos + kBK);
    k_s = q_s + kRows * kDp;
    v_s = k_s + kBK * kDp;
    p_s = v_s + kBK * kD;
    m_s = p_s + kRows * kPs;
    l_s = m_s + kRows;
    c_s = l_s + kRows;
    tid = threadIdx.x;
    pr0 = (tid / 16) * 4;
    pd0 = tid % 16;
    sr0 = (tid / 8) * 2;
    sc0 = tid % 8;
    xr = tid / 4;
    xc0 = (tid % 4) * (kBK / 4);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int u = 0; u < kDPer; ++u) acc[a][u] = 0.f;
    for (int r = tid; r < kRows; r += kThreads) {
      m_s[r] = NEG_INF;
      l_s[r] = 0.f;
    }
  }

  // query rows r whose token r / G is below nq, from q + offset(r) (the
  // element offset of the row's first value); the other rows are zero
  template <typename Offset>
  __device__ __forceinline__ void load_queries(const T* __restrict__ q, Offset offset,
                                               int nq, int G) {
    for (int i = tid; i < kRows * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      q_s[r * kDp + d] = r / G < nq ? to_f32(q[offset(r) + d]) : 0.f;
    }
  }

  // stage the kBK key rows of kpos / krow from `keys` / `vals` (zero rows
  // where invalid): kBatch loads per thread are issued before any is
  // stored, so the memory latency overlaps instead of adding up.  The
  // caller has filled kpos / krow and synchronised.
  __device__ __forceinline__ void stage(const T* __restrict__ keys,
                                        const T* __restrict__ vals) {
#pragma unroll
    for (int base = 0; base < kBK * kD; base += kBatch * kThreads) {
      float kx[kBatch], vx[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        kx[u] = 0.f;
        vx[u] = 0.f;
        if (i < kBK * kD && kpos[i / kD] >= 0) {
          const size_t at = static_cast<size_t>(krow[i / kD]) + i % kD;
          kx[u] = to_f32(keys[at]);
          vx[u] = to_f32(vals[at]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < kBK * kD) {
          k_s[(i / kD) * kDp + i % kD] = kx[u];
          v_s[i] = vx[u];
        }
      }
    }
    __syncthreads();
  }

  // one staged key tile -> scores, online softmax, P.V; row r is the query
  // at position q_base + r / G, live iff r / G < nq
  __device__ __forceinline__ void update(int q_base, int nq, int G, int window,
                                         bool causal, float scale) {
    {
      float s[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[a][u] = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) {
        const float qa = q_s[sr0 * kDp + d], qb = q_s[(sr0 + 1) * kDp + d];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float kv = k_s[(sc0 + 8 * u) * kDp + d];
          s[0][u] += qa * kv;
          s[1][u] += qb * kv;
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = sr0 + a;
        const int q_pos = q_base + r / G;
        const bool live = r / G < nq;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = sc0 + 8 * u;
          p_s[r * kPs + c] = (live && visible(kpos[c], q_pos, window, causal))
                                 ? s[a][u] * scale
                                 : NEG_INF;
        }
      }
    }
    __syncthreads();
    {
      // four threads per row (adjacent lanes), eight columns each
      const int q_pos = q_base + xr / G;
      const bool live = xr / G < nq;
      float* pr = p_s + xr * kPs;
      float mx = NEG_INF;
#pragma unroll
      for (int c = xc0; c < xc0 + kBK / 4; ++c)
        if (live && visible(kpos[c], q_pos, window, causal)) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_s[xr], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = xc0; c < xc0 + kBK / 4; ++c) {
        float p = 0.f;
        if (live && visible(kpos[c], q_pos, window, causal)) p = expf(pr[c] - m_new);
        sum += p;
        pr[c] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((tid & 3) == 0) {
        const float corr = expf(m_s[xr] - m_new);
        l_s[xr] = l_s[xr] * corr + sum;
        m_s[xr] = m_new;
        c_s[xr] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = c_s[pr0 + a];
#pragma unroll
      for (int u = 0; u < kDPer; ++u) acc[a][u] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = p_s[(pr0 + a) * kPs + c];
#pragma unroll
      for (int u = 0; u < kDPer; ++u) {
        const float v = v_s[c * kD + pd0 + 16 * u];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][u] += p[a] * v;
      }
    }
    __syncthreads();
  }

  // the live rows' results, divided by l, to out + offset(r)
  template <typename Offset>
  __device__ __forceinline__ void store(T* __restrict__ out, Offset offset, int nq,
                                        int G) const {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = pr0 + a;
      if (r / G >= nq) continue;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      T* o = out + offset(r);
#pragma unroll
      for (int u = 0; u < kDPer; ++u) o[pd0 + 16 * u] = from_f32<T>(acc[a][u] * inv);
    }
  }
};

}  // namespace flash_tile
