// Paged flash-decode: one new query token per sequence against the shared
// KV page pool, gathered through per-sequence block tables.
//
// Replaces: src/repro/kernels/decode_attention.py:186 paged_decode_attention
// (the Pallas kernel _paged_decode_kernel), called on every paged decode
// step of every layer (src/repro/models/attention.py:958).
//
// What bounds it on the H100: bytes (see decode_split.cuh, whose split-K
// walk, persistent grid and in-kernel combine it runs).  Here token t of
// sequence b lives at pool row page * P + t % P of its block-table page
// bt[b, t / P]; a token is valid iff it lies before lengths[b] on a page
// whose table entry is allocated (0 <= page < n_pages): decode_split's
// PoolRows, shared with B4.  Each lane looks up the page of each token it
// copies as it issues the copy (the table row is a few L1-resident words);
// pages may be in any order.  Tokens on a sentinel page or past a length
// are never loaded, so a non-finite value there never reaches the output.
//
// The grid is sized from the block table's capacity W * P and the SM
// count, never from the lengths: a pool of 1024 pages gives every sequence
// a capacity of 16384 tokens, and a grid of one block per (sequence, kv
// head, split) of that capacity would be mostly blocks that find nothing
// to do.
#include "common.cuh"
#include "decode_split.cuh"

namespace {

using decode_split::kThreads;
using decode_split::PoolRows;

template <typename T, int kD, int kG>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(decode_split::Args a, PoolRows rows) {
  decode_split::run<T, kD, kG>(a, rows);
}

struct Launch {
  decode_split::Args a;
  PoolRows rows;
  int quantum, stages, grid;
  cudaStream_t stream;
  template <typename T, int kD, int kG>
  cudaError_t operator()() const {
    if (!decode_split::plan_fits<T, kD, kG>(a, quantum, stages)) return cudaErrorInvalidValue;
    // the ring is dynamic shared memory; with the block's static arrays it
    // is more than the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, kD, kG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           decode_split::kRingBytes);
    if (err != cudaSuccess) return err;
    paged_decode_kernel<T, kD, kG><<<grid, kThreads, decode_split::kRingBytes, stream>>>(a, rows);
    return cudaGetLastError();
  }
};

}  // namespace

// q [B,H,D]; k_pages/v_pages [n_pages,P,Hkv,D] (16-byte aligned); bt [B,W]
// int32; lengths [B] int32; out [B,H,D]; part_acc [B,Hkv,n_split_max,G,D]
// and part_ml [B,Hkv,n_split_max,G,2] f32 scratch, counters [B,Hkv] uint32
// scratch that is zero (and left zero); the plan of
// kernels/decode_attention.py (quantum, stages, target, n_split_max,
// grid); D 16 or 128, G = H / Hkv 1 or 4, B at most 512.  All
// contiguous, all on the stream's device.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pages,
                                      const void* v_pages, const void* bt,
                                      const void* lengths, void* out, void* part_acc,
                                      void* part_ml, void* counters, int B, int H, int Hkv,
                                      int D, int n_pages, int P, int W, int quantum,
                                      int stages, int target, int n_split_max, int grid,
                                      float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || P <= 0 || W <= 0 || n_pages <= 0 || grid <= 0)
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
                           scale};
  f.rows = PoolRows{static_cast<const int*>(bt), W, P, n_pages};
  f.quantum = quantum;
  f.stages = stages;
  f.grid = grid;
  f.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(decode_split::dispatch(dtype, D, H / Hkv, f));
}
