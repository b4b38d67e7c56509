// Dense flash-decode: one new query token per sequence against its own
// slot of the dense decode arena [B, S, Hkv, D], of which the leading
// lengths[b] positions are valid.
//
// Replaces: src/repro/kernels/decode_attention.py:96 decode_attention (the
// Pallas kernel _decode_kernel).  The port calls it on every dense-arena
// decode step of every layer (models/attention.py attn_decode, whose
// reference masks with s <= pos or pos >= S, i.e. s < min(pos + 1, S)).
//
// What bounds it on the H100: bytes.  A decode step reads every valid K/V
// row of the batch once and does 4*D flops per row and query head, far
// below the ~295 flops per byte at which the tensor cores would bind.
//
// Layout: the split-K walk of the paged kernel (decode_split.cuh), with the
// arena row of token t of sequence b at b * S + t, and its combine pass
// (paged_decode_combine.cuh, with one S-token "page" per sequence).  At
// B = 4 and Hkv = 8 one block per (b, kv head) would fill 32 of 132 SMs;
// splitting each sequence's walk into `split`-token pieces gives every SM
// several blocks.  Splits at or past lengths[b] return at once and are not
// read by the combine pass.  Rows at or past lengths[b] (stale contents of
// a retired request, or never written) are never loaded: their staged K/V
// are zero and their p is 0, so nothing they hold reaches the output.
#include "common.cuh"
#include "decode_split.cuh"
#include "paged_decode_combine.cuh"

namespace {

using decode_split::kThreads;
using decode_split::kTok;

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
dense_decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     float* __restrict__ part_acc, float* __restrict__ part_ml, int H,
                     int Hkv, int S, int split, float scale) {
  const int b = blockIdx.x;
  const int first = b * S;                 // arena row of token 0 of sequence b
  auto locate = [=](int t) { return first + t; };
  decode_split::walk<T, kD>(q, k, v, locate, min(lengths[b], S), part_acc, part_ml, H,
                            Hkv, split, scale);
}

template <typename T, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, void* part_acc, void* part_ml, int B, int H, int Hkv,
                   int S, int split, int n_split, float scale, cudaStream_t stream) {
  const size_t smem = decode_split::smem_bytes<kD>(H / Hkv);
  cudaError_t err = allow_smem(dense_decode_partial<T, kD>, smem);
  if (err != cudaSuccess) return err;
  dense_decode_partial<T, kD><<<dim3(B, Hkv, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), H, Hkv, S, split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the combine pass sees the arena as one S-token page per sequence
  paged_decode_combine<T><<<dim3(B, Hkv), kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, kD, S, 1, split,
      n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* part_acc, void* part_ml,
                     int B, int H, int Hkv, int S, int split, int n_split, float scale,
                     cudaStream_t st) {
  // the head dims of the configurations served: 16 (reduced), 128 (full)
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, part_acc, part_ml, B, H, Hkv, S, split,
                           n_split, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, part_acc, part_ml, B, H, Hkv, S, split,
                            n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D]; k_cache/v_cache [B,S,Hkv,D]; lengths [B] int32; out [B,H,D];
// part_acc [B,Hkv,n_split,G,D] and part_ml [B,Hkv,n_split,G,2] f32 scratch,
// n_split = ceil(S / split), split a multiple of 32 tokens; D 16 or 128.
// All contiguous, all on the stream's device.  Returns the CUDA error code
// of the launches (0 on success).
extern "C" int decode_attention(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, const void* lengths, void* out,
                                void* part_acc, void* part_ml, int B, int H, int Hkv,
                                int D, int S, int split, int n_split, float scale,
                                void* stream) {
  if (B <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv != 0 || S <= 0 || split <= 0 || split % kTok != 0 ||
      n_split != (S + split - 1) / split)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return static_cast<int>(launch_d<float>(D, q, k_cache, v_cache, lengths, out,
                                            part_acc, part_ml, B, H, Hkv, S, split,
                                            n_split, scale, st));
  if (dtype == DTYPE_BF16)
    return static_cast<int>(launch_d<__nv_bfloat16>(D, q, k_cache, v_cache, lengths, out,
                                                    part_acc, part_ml, B, H, Hkv, S,
                                                    split, n_split, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
