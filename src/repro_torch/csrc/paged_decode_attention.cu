// Paged flash-decode: one new query token per sequence against the shared
// KV page pool, gathered through per-sequence block tables.
//
// Replaces: src/repro/kernels/decode_attention.py:186 paged_decode_attention
// (the Pallas kernel _paged_decode_kernel), called on every paged decode
// step of every layer (src/repro/models/attention.py:958).
//
// What bounds it on the H100: bytes.  A decode step reads every live K/V
// row of the batch once and does 4*D flops per row and query head, far
// below the ~295 flops per byte at which the tensor cores would bind.
//
// Layout, in two passes (split-K "flash-decoding"):
//
// 1. paged_decode_partial — one block per (sequence b, kv head h, split z
//    of `split` tokens) runs the split walk of decode_split.cuh over the
//    pool rows its block table names.  A token is valid iff it lies before
//    lengths[b] on a page whose table entry is allocated (< n_pages); a
//    non-finite value on a masked row or a sentinel page never reaches the
//    output.
// 2. paged_decode_combine (paged_decode_combine.cuh) — one block per
//    (b, h): rescales the splits that hold tokens to their common max,
//    sums, divides by l (clamped at 1e-30) and writes the result in q's
//    dtype.
//
// CUDA-core FMAs out of shared memory; wgmma/TMA are not needed to reach
// the byte bound of a one-token query, but a persistent, pipelined walk is
// the next step for this kernel.
#include "common.cuh"
#include "decode_split.cuh"
#include "paged_decode_combine.cuh"

namespace {

using decode_split::kThreads;
using decode_split::kTok;

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
paged_decode_partial(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages, const int* __restrict__ bt,
                     const int* __restrict__ lengths, float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int H, int Hkv, int n_pages,
                     int P, int W, int split, float scale) {
  const int b = blockIdx.x;
  const int* bt_row = bt + static_cast<size_t>(b) * W;
  // token t lives at pool row page * P + t % P of its block-table page
  auto locate = [=](int t) {
    const int page = bt_row[t / P];
    return page >= 0 && page < n_pages ? page * P + t % P : -1;
  };
  decode_split::walk<T, kD>(q, k_pages, v_pages, locate, min(lengths[b], W * P),
                            part_acc, part_ml, H, Hkv, split, scale);
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bt,
                   const void* lengths, void* out, void* part_acc, void* part_ml,
                   int B, int H, int Hkv, int n_pages, int P, int W, int split,
                   int n_split, float scale, cudaStream_t stream) {
  const size_t smem = decode_split::smem_bytes<kD>(H / Hkv);
  cudaError_t err = allow_smem(paged_decode_partial<T, kD>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_partial<T, kD><<<dim3(B, Hkv, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(lengths),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, Hkv, n_pages, P,
      W, split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine<T><<<dim3(B, Hkv), kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, kD, P, W, split,
      n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* bt,
                     const void* lengths, void* out, void* part_acc, void* part_ml,
                     int B, int H, int Hkv, int n_pages, int P, int W, int split,
                     int n_split, float scale, cudaStream_t st) {
  // the head dims of the configurations served: 16 (reduced), 128 (full)
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, bt, lengths, out, part_acc, part_ml, B, H, Hkv,
                           n_pages, P, W, split, n_split, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, bt, lengths, out, part_acc, part_ml, B, H, Hkv,
                            n_pages, P, W, split, n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D]; k_pages/v_pages [n_pages,P,Hkv,D]; bt [B,W] int32;
// lengths [B] int32; out [B,H,D]; part_acc [B,Hkv,n_split,G,D] and part_ml
// [B,Hkv,n_split,G,2] f32 scratch, n_split = ceil(W*P / split), split a
// multiple of 32 tokens; D 16 or 128.  All contiguous, all
// on the stream's device.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pages,
                                      const void* v_pages, const void* bt,
                                      const void* lengths, void* out, void* part_acc,
                                      void* part_ml, int B, int H, int Hkv, int D,
                                      int n_pages, int P, int W, int split,
                                      int n_split, float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || P <= 0 || W <= 0 || n_pages <= 0 ||
      split <= 0 || split % kTok != 0 || n_split != (W * P + split - 1) / split)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch_d<float>(D, q, k_pages, v_pages, bt, lengths, out,
                                            part_acc, part_ml, B, H, Hkv, n_pages, P,
                                            W, split, n_split, scale, st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_d<__nv_bfloat16>(D, q, k_pages, v_pages, bt, lengths,
                                                    out, part_acc, part_ml, B, H, Hkv,
                                                    n_pages, P, W, split, n_split, scale,
                                                    st));
  return static_cast<int>(cudaErrorInvalidValue);
}
