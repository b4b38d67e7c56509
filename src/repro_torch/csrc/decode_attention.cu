// Dense flash-decode: one new query token per sequence against its own
// slot of the dense decode arena [B, S, Hkv, D], of which the leading
// lengths[b] positions are valid.
//
// Replaces: src/repro/kernels/decode_attention.py:96 decode_attention (the
// Pallas kernel _decode_kernel).  The port calls it on every dense-arena
// decode step of every layer (models/attention.py attn_decode, whose
// reference masks with s <= pos or pos >= S, i.e. s < min(pos + 1, S)).
//
// What bounds it on the H100: bytes (see decode_split.cuh, whose split-K
// walk, persistent grid and in-kernel combine it runs).  Here the row of
// token t of sequence b is the arena row b * S + t: one kv head's rows of
// a sequence are a strided box of tokens x D, each row a run of 16-byte
// pieces that cp.async copies straight into a warp's ring.  Rows at or past
// lengths[b] (stale contents of a retired request, or never written) are
// never loaded.
#include "common.cuh"
#include "decode_split.cuh"

namespace {

using decode_split::kThreads;

struct ArenaRows {
  int S;
  __device__ __forceinline__ long long operator()(int b, int t) const {
    return static_cast<long long>(b) * S + t;
  }
};

template <typename T, int kD, int kG>
__global__ void __launch_bounds__(kThreads, 2)
dense_decode_kernel(decode_split::Args a, ArenaRows rows) {
  decode_split::run<T, kD, kG>(a, rows);
}

struct Launch {
  decode_split::Args a;
  ArenaRows rows;
  int quantum, stages, grid;
  cudaStream_t stream;
  template <typename T, int kD, int kG>
  cudaError_t operator()() const {
    if (!decode_split::plan_fits<T, kD, kG>(a, quantum, stages)) return cudaErrorInvalidValue;
    // the ring is dynamic shared memory; with the block's static arrays it
    // is more than the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(dense_decode_kernel<T, kD, kG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           decode_split::kRingBytes);
    if (err != cudaSuccess) return err;
    dense_decode_kernel<T, kD, kG><<<grid, kThreads, decode_split::kRingBytes, stream>>>(a, rows);
    return cudaGetLastError();
  }
};

}  // namespace

// q [B,H,D]; k_cache/v_cache [B,S,Hkv,D] (16-byte aligned); lengths [B]
// int32; out [B,H,D]; part_acc [B,Hkv,n_split_max,G,D] and part_ml
// [B,Hkv,n_split_max,G,2] f32 scratch, counters [B,Hkv] uint32 scratch
// that is zero (and left zero); the plan of kernels/decode_attention.py
// (quantum, stages, target, n_split_max, grid); D 16 or 128, G = H / Hkv
// 1 or 4, B at most 512.  All contiguous, all on the stream's
// device.  Returns the CUDA error code of the launch (0 on success).
extern "C" int decode_attention(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths, void* out,
                                void* part_acc, void* part_ml, void* counters, int B,
                                int H, int Hkv, int D, int S, int quantum, int stages,
                                int target, int n_split_max, int grid, float scale,
                                void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || S <= 0 || grid <= 0) return cudaErrorInvalidValue;
  Launch f;
  f.a = decode_split::Args{q,
                           k_cache,
                           v_cache,
                           static_cast<const int*>(lengths),
                           out,
                           static_cast<float*>(part_acc),
                           static_cast<float*>(part_ml),
                           static_cast<unsigned*>(counters),
                           B,
                           H,
                           Hkv,
                           S,
                           target,
                           n_split_max,
                           scale};
  f.rows = ArenaRows{S};
  f.quantum = quantum;
  f.stages = stages;
  f.grid = grid;
  f.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(decode_split::dispatch(dtype, D, H / Hkv, f));
}
