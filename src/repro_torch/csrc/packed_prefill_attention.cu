// Packed-prefill attention: segment-masked online softmax over one flat
// stream of N prefill chunks ("segments"), each attending to its own KV
// history in the page pool plus the causally visible tokens of its own
// segment in the stream.
//
// Replaces: src/repro/kernels/flash_attention.py:217 packed_prefill_attention
// (the Pallas kernel _packed_prefill_kernel), called by
// attn_chunk_packed_paged (src/repro/models/attention.py:676) on every
// packed prefill step of every layer.
//
// What bounds it on the H100: bytes for short histories and short chunks
// (each K/V row is read once per query tile), operations once histories
// and chunks are long (the work grows with chunk length x visible keys,
// the bytes only with their sum).
//
// Layout: the reference tiles the FLAT stream and assumes that a query tile
// never straddles two segments, which holds only when every segment start
// is aligned to the tile (pack_align >= 128).  The serving default aligns
// segments to 8 tokens.  This kernel tiles PER SEGMENT instead: one block
// per (segment n, kv head h, query tile of BQ tokens inside
// [starts[n], starts[n] + lengths[n])), so any alignment works, no tile
// straddles a boundary, and no segment-of-tile lookup is needed.  A block
// holds BQ tokens x the G query heads of its GQA group (kRows = BQ * G
// rows) against one kv head, so a K/V row is read once for all G heads.
// The grid is sized by the stream length (an upper bound on any segment);
// blocks past their segment's end, and every block of a pad segment
// (lengths == 0 or starts == T), return at once.  Rows outside every real
// segment are not written: the wrapper hands in a zeroed output.
//
// Each block first walks its segment's history: logical ring slot s of the
// block-table row holds position off-1-((off-1-s) mod ring), which is
// written only for s < off, so the walk covers s < min(ring, off, W*P) and
// is empty when offsets[n] == 0.  Slots on sentinel pages (>= n_pages) are
// invalid keys.  It then walks the segment's own stream keys up to the
// tile's last query (causal).  A query at position q_pos sees a key at
// position k_pos iff 0 <= k_pos <= q_pos and, with a window, q_pos - k_pos
// < window (flash_attention.py:175-207).  Invalid keys load as zero rows and
// masked scores get p = 0, so no masked value is ever multiplied in.
// Scores, the online softmax and P.V accumulate in f32; p is rounded to the
// value dtype before P.V; l is clamped at 1e-30.
//
// Each key tile of kBK keys is staged in shared memory with kBatch loads in
// flight per thread; each thread then computes a 2 x 4 block of the scores
// and keeps a 4-row x kD/16 block of the P.V accumulator in registers, so
// every value read from shared memory feeds several FMAs (shared-memory
// bandwidth, not the FMA units, is what binds a CUDA-core version).  Tensor
// cores (wgmma) and TMA-fed pipelines are the next step.
#include "common.cuh"

namespace {

constexpr int kRows = 64;     // (token, head) query rows per block
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 256;
constexpr int kBatch = 8;     // loads in flight per thread while staging

__device__ __forceinline__ bool visible(int k_pos, int q_pos, int window) {
  return k_pos >= 0 && k_pos <= q_pos && (window <= 0 || q_pos - k_pos < window);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
packed_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                      const T* __restrict__ v_new, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages, const int* __restrict__ bt,
                      const int* __restrict__ starts, const int* __restrict__ offsets,
                      const int* __restrict__ lengths, T* __restrict__ out,
                      int T_len, int H, int Hkv, int n_pages, int P, int W,
                      int ring, int window, float scale) {
  constexpr int kDp = kD + 1;             // padded rows: no bank conflicts
  constexpr int kPs = kBK + 1;
  constexpr int kDPer = kD / 16;          // accumulator columns per thread
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hkv;
  const int BQ = kRows / G;               // tokens per query tile
  const int start = starts[n], off = offsets[n], len = lengths[n];
  if (len <= 0 || start >= T_len) return;  // pad segment: no work
  const int q0 = blockIdx.z * BQ;          // first query index in the segment
  if (q0 >= len) return;
  const int nq = min(BQ, len - q0);        // real query tokens in this tile
  extern __shared__ long long smem[];
  long long* krow = smem;                  // [kBK] element offset of each
                                           // staged key row (its head's slice)
  int* kpos = reinterpret_cast<int*>(krow + kBK);  // [kBK] positions, -1 = invalid
  float* q_s = reinterpret_cast<float*>(kpos + kBK);  // [kRows][kDp]
  float* k_s = q_s + kRows * kDp;          // [kBK][kDp]
  float* v_s = k_s + kBK * kDp;            // [kBK][kD]
  float* p_s = v_s + kBK * kD;             // [kRows][kPs] scores, then p
  float* m_s = p_s + kRows * kPs;          // [kRows] running max
  float* l_s = m_s + kRows;                // [kRows] running denominator
  float* c_s = l_s + kRows;                // [kRows] this tile's correction
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(Hkv) * kD;  // token stride

  // query rows: row r is (token q0 + r / G, head h * G + r % G)
  for (int i = tid; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int qr = r / G;
    float x = 0.f;
    if (qr < nq)
      x = to_f32(q[(static_cast<size_t>(start + q0 + qr) * H + h * G + r % G) * kD + d]);
    q_s[r * kDp + d] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // this thread's P.V block: rows pr0..pr0+3, columns pd0 + 16 * u
  const int pr0 = (tid / 16) * 4, pd0 = tid % 16;
  float acc[4][kDPer];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int u = 0; u < kDPer; ++u) acc[a][u] = 0.f;
  // this thread's score block: rows sr0, sr0+1, columns sc0 + 8 * u
  const int sr0 = (tid / 8) * 2, sc0 = tid % 8;
  // this thread's softmax share: row tid / 4, columns (tid % 4) * 8 ...+7
  const int xr = tid / 4, xc0 = (tid % 4) * (kBK / 4);

  // stage the kBK key rows of kpos / krow from `keys` / `vals` (zero rows
  // where invalid): kBatch loads per thread are issued before any is
  // stored, so the memory latency overlaps instead of adding up
  auto stage = [&](const T* keys, const T* vals) {
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
  };

  // one staged key tile -> scores, online softmax, P.V
  auto update = [&]() {
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
        const int q_pos = off + q0 + r / G;
        const bool live = r / G < nq;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = sc0 + 8 * u;
          p_s[r * kPs + c] =
              (live && visible(kpos[c], q_pos, window)) ? s[a][u] * scale : NEG_INF;
        }
      }
    }
    __syncthreads();
    {
      // four threads per row (adjacent lanes), eight columns each
      const int q_pos = off + q0 + xr / G;
      const bool live = xr / G < nq;
      float* pr = p_s + xr * kPs;
      float mx = NEG_INF;
#pragma unroll
      for (int c = xc0; c < xc0 + kBK / 4; ++c)
        if (live && visible(kpos[c], q_pos, window)) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_s[xr], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = xc0; c < xc0 + kBK / 4; ++c) {
        float p = 0.f;
        if (live && visible(kpos[c], q_pos, window)) p = expf(pr[c] - m_new);
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
  };

  // 1. the segment's history in the page pool
  const int n_hist = off > 0 ? min(min(ring, off), W * P) : 0;
  const int* bt_row = bt + static_cast<size_t>(n) * W;
  for (int t0 = 0; t0 < n_hist; t0 += kBK) {
    if (tid < kBK) {
      const int s = t0 + tid;
      int pos = -1;
      long long at = 0;
      if (s < n_hist) {
        const int page = bt_row[s / P];
        if (page >= 0 && page < n_pages) {
          int x = (off - 1 - s) % ring;
          if (x < 0) x += ring;
          pos = off - 1 - x;
          at = (static_cast<long long>(page) * P + s % P) * static_cast<long long>(row) +
               static_cast<long long>(h) * kD;
        }
      }
      kpos[tid] = pos;
      krow[tid] = at;
    }
    __syncthreads();
    stage(k_pages, v_pages);
    update();
  }

  // 2. the segment's own stream keys, causal: none past the tile's last query
  const int k_end = q0 + nq;
  for (int t0 = 0; t0 < k_end; t0 += kBK) {
    if (tid < kBK) {
      const bool ok = t0 + tid < k_end;
      kpos[tid] = ok ? off + t0 + tid : -1;
      krow[tid] = ok ? static_cast<long long>(start + t0 + tid) * static_cast<long long>(row) +
                           static_cast<long long>(h) * kD
                     : 0;
    }
    __syncthreads();
    stage(k_new, v_new);
    update();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = pr0 + a;
    if (r / G >= nq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* o = out + (static_cast<size_t>(start + q0 + r / G) * H + h * G + r % G) * kD;
#pragma unroll
    for (int u = 0; u < kDPer; ++u) o[pd0 + 16 * u] = from_f32<T>(acc[a][u] * inv);
  }
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pages, const void* v_pages, const void* bt,
                   const void* starts, const void* offsets, const void* lengths,
                   void* out, int T_len, int H, int Hkv, int N, int n_pages,
                   int P, int W, int ring, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const int BQ = kRows / G;
  const size_t smem =
      (static_cast<size_t>(kRows) * (kD + 1) + kBK * (kD + 1) + kBK * kD +
       kRows * (kBK + 1) + 3 * kRows) * sizeof(float) +
      kBK * (sizeof(long long) + sizeof(int));
  cudaError_t err = allow_smem(packed_prefill_kernel<T, kD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N, Hkv, (T_len + BQ - 1) / BQ);
  packed_prefill_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(bt), static_cast<const int*>(starts),
      static_cast<const int*>(offsets), static_cast<const int*>(lengths),
      static_cast<T*>(out), T_len, H, Hkv, n_pages, P, W, ring, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k_new, const void* v_new,
                     const void* k_pages, const void* v_pages, const void* bt,
                     const void* starts, const void* offsets, const void* lengths,
                     void* out, int T_len, int H, int Hkv, int N, int n_pages, int P,
                     int W, int ring, int window, float scale, cudaStream_t st) {
#define PACKED_PREFILL_CASE(DIM)                                                  \
  case DIM:                                                                       \
    return launch<T, DIM>(q, k_new, v_new, k_pages, v_pages, bt, starts, offsets, \
                          lengths, out, T_len, H, Hkv, N, n_pages, P, W, ring,    \
                          window, scale, st);
  // the head dims of the configurations served: 16 (reduced), 128 (full)
  switch (D) {
    PACKED_PREFILL_CASE(16)
    PACKED_PREFILL_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PACKED_PREFILL_CASE
}

}  // namespace

// q [T,H,D]; k_new/v_new [T,Hkv,D]; k_pages/v_pages [n_pages,P,Hkv,D];
// bt [N,W] int32; starts/offsets/lengths [N] int32; out [T,H,D], zeroed by
// the caller.  G = H / Hkv must divide 64; D 16 or 128.  All
// contiguous, all on the stream's device.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int packed_prefill_attention(int dtype, const void* q, const void* k_new,
                                        const void* v_new, const void* k_pages,
                                        const void* v_pages, const void* bt,
                                        const void* starts, const void* offsets,
                                        const void* lengths, void* out, int T_len,
                                        int H, int Hkv, int D, int N, int n_pages,
                                        int P, int W, int ring, int window,
                                        float scale, void* stream) {
  if (T_len <= 0 || N <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || kRows % (H / Hkv) != 0 || P <= 0 || W <= 0 ||
      n_pages <= 0 || ring <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch_d<float>(D, q, k_new, v_new, k_pages, v_pages, bt,
                                            starts, offsets, lengths, out, T_len, H,
                                            Hkv, N, n_pages, P, W, ring, window, scale,
                                            st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_d<__nv_bfloat16>(D, q, k_new, v_new, k_pages,
                                                    v_pages, bt, starts, offsets,
                                                    lengths, out, T_len, H, Hkv, N,
                                                    n_pages, P, W, ring, window,
                                                    scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
