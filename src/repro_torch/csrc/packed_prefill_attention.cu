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
// < window (flash_attention.py:175-207).  Invalid keys are zero rows and
// masked scores get p = 0, so no masked value is ever multiplied in.
// Scores, the online softmax and P.V accumulate in f32; p is rounded to the
// value dtype before P.V; l is clamped at 1e-30.
//
// Two routes behind one entry point, by dtype and head dim:
//
// bf16 at D = 64 or 128 (every full-width main path): flash_wgmma.cuh's
// tensor-core step, 128 query rows (128 / G tokens x G heads) per block,
// query tiles numbered from the end of each segment so that the longest
// walks are scheduled first.
// Its producer warp stages 64-key tiles by TMA: the stream's keys and
// values through 3-D tensor maps over [T, Hkv, D] (a box of 64 tokens x
// one head, token stride Hkv*D); the history through maps over the pool
// seen as [n_pages*P, Hkv, D], one box of B rows per page run of the tile,
// where B is the largest power of two dividing P, at most 64 (P = 16: four
// boxes a tile; the dense arena's one-page view, P = R: one).  The producer
// reads the block-table row itself; sentinel pages and slots past the
// history are never loaded (their rows are zeroed), and rows of a loaded
// box past the history's or the segment's end are zeroed once it lands.
// A box is at least one 1024-byte swizzle atom of 8 rows, so this route
// takes pools whose P is a multiple of 8.
//
// f32 at any D, bf16 at D = 16 (the reduced configurations), and bf16 over
// pages of a size that is no multiple of 8: the CUDA-core tile of
// flash_tile.cuh (register tiles, f32 accumulation), shared with
// flash_attention.cu, 64 query rows per block.
#include "common.cuh"
#include "flash_tile.cuh"
#include "flash_wgmma.cuh"

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

// ---------------------------------------------------------------------------
// bf16, D = 64 or 128: tensor cores
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(flash_wgmma::kThreads, 1)
packed_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const int* __restrict__ bt,
                    const int* __restrict__ starts, const int* __restrict__ offsets,
                    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                    const __grid_constant__ CUtensorMap kn_map,
                    const __grid_constant__ CUtensorMap vn_map,
                    const __grid_constant__ CUtensorMap kp_map,
                    const __grid_constant__ CUtensorMap vp_map, int T_len, int H, int Hkv,
                    int n_pages, int P, int W, int ring, int window, int box,
                    float scale_log2) {
  namespace fw = flash_wgmma;
  const int n = blockIdx.x, h = blockIdx.y;
  const int G = H / Hkv;
  const int BQ = fw::kM / G;                          // tokens per warpgroup
  const int start = starts[n], off = offsets[n], len = lengths[n];
  if (len <= 0 || start >= T_len) return;           // pad segment: no work
  const int q0 = (gridDim.z - 1 - blockIdx.z) * fw::kWG * BQ;  // first query
  if (q0 >= len) return;
  const int nq = min(fw::kWG * BQ, len - q0);                  // live tokens
  extern __shared__ unsigned char smem_raw[];
  fw::Smem<kD>& sm = fw::smem_of<kD>(smem_raw);
  fw::init_barriers(sm);

  const int n_hist = off > 0 ? min(min(ring, off), W * P) : 0;
  const int k_end = q0 + nq;                         // stream keys: causal
  const int n_hist_tiles = (n_hist + fw::kBK - 1) / fw::kBK;
  const int n_tiles = n_hist_tiles + (k_end + fw::kBK - 1) / fw::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == fw::kProducerWarp) {
    const int q_lo = off + q0, q_hi = off + q0 + nq - 1;
    const int* bt_row = bt + static_cast<size_t>(n) * W;
    constexpr uint32_t kRowBytes = 2u * kD * 2;      // one K and one V row
    fw::Ring ring_;
    // 1. the history, one box of `box` rows per page run
    const int nb = fw::kBK / box;
    for (int it = 0; it < n_hist_tiles; ++it) {
      const int t0 = it * fw::kBK;
      ring_.acquire(sm);
      bool all = true;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = t0 + lane + 32 * e;
        int pos = -1;
        if (s < n_hist) {
          const int page = bt_row[s / P];
          if (page >= 0 && page < n_pages) {
            int x = (off - 1 - s) % ring;
            if (x < 0) x += ring;
            pos = off - 1 - x;
          }
        }
        sm.kpos[ring_.stage][lane + 32 * e] = pos;
        all &= pos >= 0 && (window <= 0 || q_hi - pos < window);
      }
      all = __all_sync(0xffffffffu, all);
      if (lane == 0) sm.all_visible[ring_.stage] = all;
      // lane j < nb: the page of box j, -1 when the box is not loaded
      int my_page = -1;
      if (lane < nb) {
        const int s = t0 + lane * box;
        if (s < n_hist) {
          const int page = bt_row[s / P];
          if (page >= 0 && page < n_pages) my_page = page;
        }
      }
      constexpr int kMaxBoxes = fw::kBK / 8;
      int pages[kMaxBoxes];
      int loaded = 0;
#pragma unroll
      for (int j = 0; j < kMaxBoxes; ++j) {
        pages[j] = __shfl_sync(0xffffffffu, my_page, j);
        if (j >= nb) continue;
        if (pages[j] >= 0) {
          ++loaded;
        } else {
          fw::zero_rows(sm, ring_.stage, j * box, (j + 1) * box, lane);
        }
      }
      // a loaded box that runs past the history's end
      const int tail = n_hist - t0;
      const int tail_page = __shfl_sync(0xffffffffu, my_page, min(tail / box, 31));
      const int zero_lo = tail < fw::kBK && tail % box != 0 && tail_page >= 0 ? tail : fw::kBK;
      ring_.publish(sm, lane, loaded * box * kRowBytes, zero_lo,
                    [&](uint64_t* bar, int st) {
#pragma unroll
                      for (int j = 0; j < kMaxBoxes; ++j) {
                        if (j >= nb || pages[j] < 0) continue;
                        const int row = pages[j] * P + (t0 + j * box) % P;
#pragma unroll
                        for (int c = 0; c < kD / 64; ++c) {
                          fw::tma_load_3d(&sm.k[st][c][j * box * 64], &kp_map, bar, c * 64,
                                          h, row);
                          fw::tma_load_3d(&sm.v[st][c][j * box * 64], &vp_map, bar, c * 64,
                                          h, row);
                        }
                      }
                    });
    }
    // 2. the segment's own stream keys, none past the block's last query
    for (int t0 = 0; t0 < k_end; t0 += fw::kBK) {
      ring_.acquire(sm);
      bool all = true;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + lane + 32 * e;
        const bool ok = t < k_end;
        sm.kpos[ring_.stage][lane + 32 * e] = ok ? off + t : -1;
        all &= ok && off + t <= q_lo && (window <= 0 || q_hi - (off + t) < window);
      }
      all = __all_sync(0xffffffffu, all);
      if (lane == 0) sm.all_visible[ring_.stage] = all;
      ring_.publish(sm, lane, fw::kBK * kRowBytes, min(k_end - t0, fw::kBK),
                    [&](uint64_t* bar, int st) {
#pragma unroll
                      for (int c = 0; c < kD / 64; ++c) {
                        fw::tma_load_3d(&sm.k[st][c][0], &kn_map, bar, c * 64, h, start + t0);
                        fw::tma_load_3d(&sm.v[st][c][0], &vn_map, bar, c * 64, h, start + t0);
                      }
                    });
    }
  } else {
    const int wg = warp / 4;
    // row r of warpgroup wg is (stream token start + q0 + wg * BQ + r % BQ,
    // query head h * G + r / BQ)
    const int tok0 = q0 + wg * BQ;
    auto row = [=](int r) {
      return (static_cast<size_t>(start + tok0 + r % BQ) * H + h * G + r / BQ) * kD;
    };
    fw::consume<kD>(sm, wg, n_tiles, q, out, row, BQ, min(max(nq - wg * BQ, 0), BQ),
                    off + tok0, window, true, scale_log2);
  }
}

template <int kD>
cudaError_t launch_wgmma(const void* q, const void* k_new, const void* v_new,
                         const void* k_pages, const void* v_pages, const void* bt,
                         const void* starts, const void* offsets, const void* lengths,
                         void* out, int T_len, int H, int Hkv, int N, int n_pages, int P,
                         int W, int ring, int window, float scale, cudaStream_t stream) {
  namespace fw = flash_wgmma;
  const int box = min(P & -P, fw::kBK);  // largest power of two dividing P, <= 64
  if (box < 8) return cudaErrorInvalidValue;
  // the stream [T][Hkv][D] in boxes of 64 tokens x 1 head; the pool
  // [n_pages*P][Hkv][D] in boxes of `box` rows x 1 head
  CUtensorMap kn_map, vn_map, kp_map, vp_map;
  const uint64_t row = static_cast<uint64_t>(Hkv) * kD, pool_rows =
      static_cast<uint64_t>(n_pages) * P;
  if (!fw::make_map(&kn_map, k_new, kD, Hkv, T_len, kD, row, 1, fw::kBK) ||
      !fw::make_map(&vn_map, v_new, kD, Hkv, T_len, kD, row, 1, fw::kBK) ||
      !fw::make_map(&kp_map, k_pages, kD, Hkv, pool_rows, kD, row, 1, box) ||
      !fw::make_map(&vp_map, v_pages, kD, Hkv, pool_rows, kD, row, 1, box))
    return cudaErrorInvalidValue;
  const size_t smem = fw::smem_bytes<kD>();
  cudaError_t err = allow_smem(packed_wgmma_kernel<kD>, smem);
  if (err != cudaSuccess) return err;
  const int BQB = fw::kRows / (H / Hkv);
  const dim3 grid(N, Hkv, (T_len + BQB - 1) / BQB);
  packed_wgmma_kernel<kD><<<grid, fw::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(bt),
      static_cast<const int*>(starts), static_cast<const int*>(offsets),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), kn_map, vn_map,
      kp_map, vp_map, T_len, H, Hkv, n_pages, P, W, ring, window, box,
      scale * 1.4426950408889634f);
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
// contiguous, all on the stream's device.  `route` is the wrapper's choice
// and the kernel launched: ROUTE_WGMMA (tensor cores) takes bf16 at D = 64
// or 128 with P a multiple of 8 and the float tensors 16-byte aligned;
// ROUTE_TILE (CUDA cores) takes f32 or bf16 at any of the three D.  Inputs
// the route cannot take are refused with cudaErrorInvalidValue, nothing
// launched.  Returns the CUDA error code of the launch (0 on success).
extern "C" int packed_prefill_attention(int dtype, int route, const void* q,
                                        const void* k_new, const void* v_new,
                                        const void* k_pages, const void* v_pages,
                                        const void* bt, const void* starts,
                                        const void* offsets, const void* lengths,
                                        void* out, int T_len, int H, int Hkv, int D,
                                        int N, int n_pages, int P, int W, int ring,
                                        int window, float scale, void* stream) {
  if (T_len <= 0 || N <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || kRows % (H / Hkv) != 0 || P <= 0 || W <= 0 ||
      n_pages <= 0 || ring <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_WGMMA && dtype == DTYPE_BF16 && P % 8 == 0) {
    if (D == 64)
      return static_cast<int>(launch_wgmma<64>(
          q, k_new, v_new, k_pages, v_pages, bt, starts, offsets, lengths, out, T_len, H,
          Hkv, N, n_pages, P, W, ring, window, scale, st));
    if (D == 128)
      return static_cast<int>(launch_wgmma<128>(
          q, k_new, v_new, k_pages, v_pages, bt, starts, offsets, lengths, out, T_len, H,
          Hkv, N, n_pages, P, W, ring, window, scale, st));
  }
  if (route == ROUTE_TILE && dtype == DTYPE_F32)
    return static_cast<int>(launch_d<float>(D, q, k_new, v_new, k_pages, v_pages, bt,
                                            starts, offsets, lengths, out, T_len, H,
                                            Hkv, N, n_pages, P, W, ring, window, scale,
                                            st));
  if (route == ROUTE_TILE && dtype == DTYPE_BF16)
    return static_cast<int>(launch_d<__nv_bfloat16>(D, q, k_new, v_new, k_pages,
                                                    v_pages, bt, starts, offsets,
                                                    lengths, out, T_len, H, Hkv, N,
                                                    n_pages, P, W, ring, window, scale,
                                                    st));
  return static_cast<int>(cudaErrorInvalidValue);
}
