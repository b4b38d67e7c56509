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
// Layout: one block per (query tile, kv head h, batch row b).  A tile holds
// BQ = 64 / G tokens x the G query heads of h's GQA group, so every K/V tile
// the block stages serves all G heads.  The block walks its key tiles of 32
// keys, staged in shared memory, through the register-tiled online-softmax
// step of flash_tile.cuh (shared with the packed-prefill kernel), reading
// the [B,H,T,D] / [B,Hkv,T,D] layouts directly.  Key tiles wholly outside
// the mask are never visited (the Pallas kernel's `run` predicate,
// flash_attention.py:43-47): causal, the walk ends at the tile's last query;
// windowed, it starts at the first key the tile's first query still sees.
// T need not be a multiple of any tile: queries at or past T are not live
// and keys at or past T are invalid (position -1).  Query tiles are
// numbered from the end of the prompt, so the longest walks are scheduled
// first and the short ones fill the tail.
//
// CUDA-core FMAs; wgmma and TMA-fed pipelines are the next step for it.
#include "common.cuh"
#include "flash_tile.cuh"

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

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out,
                     int B, int T_len, int H, int Hkv, int causal, int window,
                     float scale, cudaStream_t st) {
  // the head dims of the configurations served: 16 (reduced), 128 (full);
  // 64: the benchmark runner's kernel rows (benchmarks/kernel_micro.py)
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, T_len, H, Hkv, causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,T,D]; k/v [B,Hkv,T,D]; out [B,H,T,D]; causal 0/1; window 0 (full)
// or the sliding window.  G = H / Hkv must divide 64; D 16, 64 or 128.  All
// contiguous, all on the stream's device.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int flash_attention(int dtype, const void* q, const void* k, const void* v,
                               void* out, int B, int T_len, int H, int Hkv, int D,
                               int causal, int window, float scale, void* stream) {
  if (B <= 0 || T_len <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || kRows % (H / Hkv) != 0 || B > 65535 || Hkv > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch_d<float>(D, q, k, v, out, B, T_len, H, Hkv, causal,
                                            window, scale, st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_d<__nv_bfloat16>(D, q, k, v, out, B, T_len, H, Hkv,
                                                    causal, window, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
