// Flash attention for whole-prompt prefill: causal (and optionally
// windowed) online-softmax attention of q [B,H,T,D] over k/v [B,Hkv,T,D]
// (GQA: query head h*G + g reads kv head h).
//
// Replaces: src/repro/kernels/flash_attention.py:83 flash_attention (the
// Pallas kernel _flash_kernel), called by attn_prefill for prompts longer
// than dense_threshold = 2048 tokens (src/repro/models/attention.py:241-257;
// the port's models/attention.py attn_prefill).
//
// What bounds it on the H100: operations.  A causal prompt of T tokens does
// 4*D flops per (query head, visible key) pair — 5.2e11 per qwen3-8b layer
// at T = 8000 — against reading q, k, v and writing the output once.
//
// Two routes behind one entry point, by dtype and head dim:
//
// bf16 at D = 64, 128 or 160 (every full-width main path; 160 is zamba2's
// shared attention block, staged as three 64-column chunks whose last half
// TMA fills with zeros, flash_wgmma.cuh): flash_wgmma.cuh's tensor-core
// step.  One block per (query tile of 128 rows = 128 / G tokens
// x the G heads of a GQA group, kv head h, batch row b): a producer warp
// stages 64-key tiles of K and V by TMA into a ring of three stages, each
// of k and v read through one 3-D tensor map over [B*Hkv, T, D] whose
// boxes past T read as zero; two consumer warpgroups (64 rows each) run
// S = Q K^T and O += P V on wgmma with the online softmax in registers.
//
// f32 at any D, and bf16 at D = 16 (the reduced configurations): the
// CUDA-core tile of flash_tile.cuh (shared with the packed-prefill kernel),
// one block per query tile of 64 rows, key tiles of 32 keys staged in
// shared memory as f32.  f32 has no IEEE tensor-core mode, and the port's
// f32 checks hold it to 1e-4 with TF32 off.
//
// Both: key tiles wholly outside the mask are never visited (the Pallas
// kernel's `run` predicate, flash_attention.py:43-47): causal, the walk
// ends at the tile's last query; windowed, it starts at the tile holding
// the first key the tile's first query still sees.  T need not be a
// multiple of any tile: queries at or past T are not live and keys at or
// past T are invalid (position -1).  Query tiles are numbered from the end
// of the prompt, so the longest walks are scheduled first and the short
// ones fill the tail.
#include "common.cuh"
#include "flash_tile.cuh"
#include "flash_wgmma.cuh"

namespace {

using flash_tile::kBK;
using flash_tile::kRows;
using flash_tile::kThreads;

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int T_len, int H,
                       int Hkv, int causal, int window, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int BQ = kRows / G;                        // tokens per query tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // first query of the tile
  const int nq = min(BQ, T_len - q0);              // real query tokens
  extern __shared__ long long smem[];
  flash_tile::Tile<T, kD> tile(smem);
  const int tid = threadIdx.x;

  // row r is (token q0 + r / G, query head h * G + r % G)
  auto q_row = [=](int r) {
    return ((static_cast<size_t>(b) * H + h * G + r % G) * T_len + q0 + r / G) * kD;
  };
  tile.load_queries(q, q_row, nq, G);

  // the key tiles any query of this tile sees
  const int k_end = causal ? q0 + nq : T_len;
  const int k_begin = window > 0 ? max(q0 - window + 1, 0) / kBK * kBK : 0;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + h) * T_len;
  for (int t0 = k_begin; t0 < k_end; t0 += kBK) {
    if (tid < kBK) {
      const int t = t0 + tid;
      const bool ok = t < k_end;
      tile.kpos[tid] = ok ? t : -1;
      tile.krow[tid] = ok ? static_cast<long long>((kv_base + t) * kD) : 0;
    }
    __syncthreads();
    tile.stage(k, v);
    tile.update(q0, nq, G, window, causal != 0, scale);
  }

  tile.store(out, q_row, nq, G);
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int T_len, int H, int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  const int BQ = kRows / (H / Hkv);
  const size_t smem = flash_tile::smem_bytes<kD>();
  cudaError_t err = allow_smem(flash_attention_kernel<T, kD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, Hkv, B);
  flash_attention_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), T_len, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, D = 64, 128 or 160: tensor cores
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(flash_wgmma::kThreads, 1)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, int T_len, int H, int Hkv,
                   int causal, int window, float scale_log2) {
  namespace fw = flash_wgmma;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int BQ = fw::kM / G;                          // tokens per warpgroup
  const int q0 = (gridDim.x - 1 - blockIdx.x) * fw::kWG * BQ;  // first query
  const int nq = min(fw::kWG * BQ, T_len - q0);                // live tokens
  extern __shared__ unsigned char smem_raw[];
  fw::Smem<kD>& sm = fw::smem_of<kD>(smem_raw);
  fw::init_barriers(sm);

  // the key tiles any query of the block sees
  const int k_end = causal ? q0 + nq : T_len;
  const int k_begin = window > 0 ? max(q0 - window + 1, 0) / fw::kBK * fw::kBK : 0;
  const int n_tiles = (k_end - k_begin + fw::kBK - 1) / fw::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == fw::kProducerWarp) {
    const int q_lo = q0, q_hi = q0 + nq - 1;
    const int bh = b * Hkv + h;
    constexpr int kC = fw::Smem<kD>::kC;               // 64-column chunks a row
    constexpr uint32_t kBytes = 2u * fw::kBK * kC * 64 * 2;  // a K and a V tile
    fw::Ring ring;
    for (int it = 0; it < n_tiles; ++it) {
      const int t0 = k_begin + it * fw::kBK;
      ring.acquire(sm);
      bool all = true;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + lane + 32 * e;
        const bool ok = t < T_len;
        sm.kpos[ring.stage][lane + 32 * e] = ok ? t : -1;
        all &= ok && (!causal || t <= q_lo) && (window <= 0 || q_hi - t < window);
      }
      all = __all_sync(0xffffffffu, all);
      if (lane == 0) sm.all_visible[ring.stage] = all;
      ring.publish(sm, lane, kBytes, fw::kBK, [&](uint64_t* bar, int st) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          fw::tma_load_3d(&sm.k[st][c][0], &k_map, bar, c * 64, t0, bh);
          fw::tma_load_3d(&sm.v[st][c][0], &v_map, bar, c * 64, t0, bh);
        }
      });
    }
  } else {
    const int wg = warp / 4;
    // row r of warpgroup wg is (query head h * G + r / BQ, token q0 + wg * BQ + r % BQ)
    const int tok0 = q0 + wg * BQ;
    auto row = [=](int r) {
      return ((static_cast<size_t>(b) * H + h * G + r / BQ) * T_len + tok0 + r % BQ) * kD;
    };
    fw::consume<kD>(sm, wg, n_tiles, q, out, row, BQ, min(max(nq - wg * BQ, 0), BQ), tok0,
                    window, causal != 0, scale_log2);
  }
}

template <int kD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B,
                         int T_len, int H, int Hkv, int causal, int window, float scale,
                         cudaStream_t stream) {
  namespace fw = flash_wgmma;
  // k, v seen as [B*Hkv][T][D]; boxes of 64 keys x 64 values (at D = 160
  // the third box of a row reads 32 values and 32 zeros)
  CUtensorMap k_map, v_map;
  const uint64_t rows = static_cast<uint64_t>(B) * Hkv, T = T_len;
  if (!fw::make_map(&k_map, k, kD, T, rows, kD, T * kD, fw::kBK, 1) ||
      !fw::make_map(&v_map, v, kD, T, rows, kD, T * kD, fw::kBK, 1))
    return cudaErrorInvalidValue;
  const size_t smem = fw::smem_bytes<kD>();
  cudaError_t err = allow_smem(flash_wgmma_kernel<kD>, smem);
  if (err != cudaSuccess) return err;
  const int BQB = fw::kRows / (H / Hkv);
  const dim3 grid((T_len + BQB - 1) / BQB, Hkv, B);
  flash_wgmma_kernel<kD><<<grid, fw::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), k_map, v_map,
      T_len, H, Hkv, causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out,
                     int B, int T_len, int H, int Hkv, int causal, int window,
                     float scale, cudaStream_t st) {
  // the head dims of the configurations served: 16 (reduced), 128 (full),
  // 160 (zamba2's shared block); 64: the benchmark runner's kernel rows
  // (benchmarks/kernel_micro.py)
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st);
    case 160:
      return launch<T, 160>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,T,D]; k/v [B,Hkv,T,D]; out [B,H,T,D]; causal 0/1; window 0 (full)
// or the sliding window.  G = H / Hkv must divide 64; D 16, 64, 128 or
// 160.  All contiguous, all on the stream's device.  `route` is the
// wrapper's choice and the kernel launched: ROUTE_WGMMA (tensor cores)
// takes bf16 at D = 64, 128 or 160 with q, k and v 16-byte aligned; ROUTE_TILE (CUDA cores) takes f32
// at any D and bf16 at D = 16.  Inputs the route cannot take are refused
// with cudaErrorInvalidValue, nothing launched.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int flash_attention(int dtype, int route, const void* q, const void* k,
                               const void* v, void* out, int B, int T_len, int H,
                               int Hkv, int D, int causal, int window, float scale,
                               void* stream) {
  if (B <= 0 || T_len <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || kRows % (H / Hkv) != 0 || B > 65535 || Hkv > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_WGMMA && dtype == DTYPE_BF16) {
    if (D == 64)
      return static_cast<int>(
          launch_wgmma<64>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st));
    if (D == 128)
      return static_cast<int>(
          launch_wgmma<128>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st));
    if (D == 160)
      return static_cast<int>(
          launch_wgmma<160>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st));
  }
  if (route == ROUTE_TILE && dtype == DTYPE_F32)
    return static_cast<int>(launch_d<float>(D, q, k, v, out, B, T_len, H, Hkv, causal,
                                            window, scale, st));
  if (route == ROUTE_TILE && dtype == DTYPE_BF16 && D == 16)
    return static_cast<int>(launch<__nv_bfloat16, 16>(q, k, v, out, B, T_len, H, Hkv,
                                                      causal, window, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
