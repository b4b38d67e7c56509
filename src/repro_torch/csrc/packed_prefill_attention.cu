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
// The online-softmax step over each staged key tile (register tiles, f32
// accumulation) is flash_tile.cuh's, shared with flash_attention.cu.
#include "common.cuh"
#include "flash_tile.cuh"

namespace {

using flash_tile::kBK;
using flash_tile::kRows;
using flash_tile::kThreads;

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
packed_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                      const T* __restrict__ v_new, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages, const int* __restrict__ bt,
                      const int* __restrict__ starts, const int* __restrict__ offsets,
                      const int* __restrict__ lengths, T* __restrict__ out,
                      int T_len, int H, int Hkv, int n_pages, int P, int W,
                      int ring, int window, float scale) {
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
  flash_tile::Tile<T, kD> tile(smem);
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(Hkv) * kD;  // token stride

  // row r is (token q0 + r / G, head h * G + r % G) of the flat stream
  auto q_row = [=](int r) {
    return (static_cast<size_t>(start + q0 + r / G) * H + h * G + r % G) * kD;
  };
  tile.load_queries(q, q_row, nq, G);

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
      tile.kpos[tid] = pos;
      tile.krow[tid] = at;
    }
    __syncthreads();
    tile.stage(k_pages, v_pages);
    tile.update(off + q0, nq, G, window, true, scale);
  }

  // 2. the segment's own stream keys, causal: none past the tile's last query
  const int k_end = q0 + nq;
  for (int t0 = 0; t0 < k_end; t0 += kBK) {
    if (tid < kBK) {
      const bool ok = t0 + tid < k_end;
      tile.kpos[tid] = ok ? off + t0 + tid : -1;
      tile.krow[tid] = ok ? static_cast<long long>(start + t0 + tid) *
                                    static_cast<long long>(row) +
                                static_cast<long long>(h) * kD
                          : 0;
    }
    __syncthreads();
    tile.stage(k_new, v_new);
    tile.update(off + q0, nq, G, window, true, scale);
  }

  tile.store(out, q_row, nq, G);
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* k_pages, const void* v_pages, const void* bt,
                   const void* starts, const void* offsets, const void* lengths,
                   void* out, int T_len, int H, int Hkv, int N, int n_pages,
                   int P, int W, int ring, int window, float scale,
                   cudaStream_t stream) {
  const int BQ = kRows / (H / Hkv);
  const size_t smem = flash_tile::smem_bytes<kD>();
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
  // the head dims of the configurations served: 16 (reduced), 128 (full);
  // 64: the benchmark runner's kernel rows (benchmarks/kernel_micro.py)
  switch (D) {
    PACKED_PREFILL_CASE(16)
    PACKED_PREFILL_CASE(64)
    PACKED_PREFILL_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef PACKED_PREFILL_CASE
}

}  // namespace

// q [T,H,D]; k_new/v_new [T,Hkv,D]; k_pages/v_pages [n_pages,P,Hkv,D];
// bt [N,W] int32; starts/offsets/lengths [N] int32; out [T,H,D], zeroed by
// the caller.  G = H / Hkv must divide 64; D 16, 64 or 128.  All
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
