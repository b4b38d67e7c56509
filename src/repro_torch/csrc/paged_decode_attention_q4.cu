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
// Layout: B1's split-K walk (decode_split.cuh: a persistent grid over
// (sequence, kv head, split) units built on the card from the lengths,
// each warp streaming its chunks through a ring of asynchronous copies,
// the combine in the same launch) over decode_split's PoolRows, with the
// int4 stage and walk (Q4Geom, Q4Walk): a chunk's packed K and V rows in
// 16-byte pieces (8 at D = 16) and its tokens' scales beside them, the
// codes unpacked in registers and the arithmetic f32 on the CUDA cores with
// q, p and the accumulators in f32 — the reference's q4 kernel keeps q, p
// and the dequantized V in f32 (decode_attention.py:279-305), and rounding
// p to bf16 for the tensor cores would change the result.  A token is valid
// iff it lies before lengths[b] on a page whose table entry is allocated
// (< n_pages); invalid rows and their scales are never loaded (zero-filled,
// p = 0), so a NaN scale there never reaches the output.
#include <cstdint>

#include "common.cuh"
#include "decode_split.cuh"

namespace {

using decode_split::kThreads;
using decode_split::PoolRows;

template <typename T, int kD, int kG>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_q4_kernel(decode_split::Args a, PoolRows rows) {
  decode_split::run<T, kD, kG, PoolRows, decode_split::Q4Walk<T, kD, kG>>(a, rows);
}

struct Launch {
  decode_split::Args a;
  PoolRows rows;
  int quantum, stages, grid;
  cudaStream_t stream;
  template <typename T, int kD, int kG>
  cudaError_t operator()() const {
    if (!decode_split::plan_fits<T, kD, kG, decode_split::Q4Geom<kD>>(a, quantum, stages))
      return cudaErrorInvalidValue;
    // the ring is dynamic shared memory; with the block's static arrays it
    // is more than the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(paged_decode_q4_kernel<T, kD, kG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           decode_split::kRingBytes);
    if (err != cudaSuccess) return err;
    paged_decode_q4_kernel<T, kD, kG>
        <<<grid, kThreads, decode_split::kRingBytes, stream>>>(a, rows);
    return cudaGetLastError();
  }
};

}  // namespace

// q [B,H,D] (dtype DTYPE_F32/BF16); k_pages/v_pages [n_pages,P,Hkv,D/2]
// uint8 nibble pairs, 16-byte aligned; k_scales/v_scales [n_pages,P,Hkv]
// f32; bt [B,W] int32; lengths [B] int32; out [B,H,D] in q's dtype;
// part_acc [B,Hkv,n_split_max,G,D] and part_ml [B,Hkv,n_split_max,G,2] f32
// scratch, counters [B,Hkv] uint32 scratch that is zero (and left zero);
// the plan of kernels/decode_attention.py for packed pages (quantum,
// stages, target, n_split_max, grid); D 16 or 128, G = H / Hkv 1 or 4, B
// at most 512.  All contiguous, all on the stream's device.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int paged_decode_attention_q4(int dtype, const void* q, const void* k_pages,
                                         const void* k_scales, const void* v_pages,
                                         const void* v_scales, const void* bt,
                                         const void* lengths, void* out, void* part_acc,
                                         void* part_ml, void* counters, int B, int H, int Hkv,
                                         int D, int n_pages, int P, int W, int quantum,
                                         int stages, int target, int n_split_max, int grid,
                                         float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || P <= 0 || W <= 0 || n_pages <= 0 || grid <= 0 ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
    return cudaErrorInvalidValue;
  Launch f;
  f.a = decode_split::Args{q,
                           k_pages,
                           v_pages,
                           static_cast<const int*>(lengths),
                           out,
                           static_cast<float*>(part_acc),
                           static_cast<float*>(part_ml),
                           static_cast<unsigned*>(counters),
                           B,
                           H,
                           Hkv,
                           W * P,
                           target,
                           n_split_max,
                           scale,
                           static_cast<const float*>(k_scales),
                           static_cast<const float*>(v_scales)};
  f.rows = PoolRows{static_cast<const int*>(bt), W, P, n_pages};
  f.quantum = quantum;
  f.stages = stages;
  f.grid = grid;
  f.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(decode_split::dispatch(dtype, D, H / Hkv, f));
}
