// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// The kernels take bf16 or f32 tensors and accumulate in f32.  Values are
// widened with the CUDA intrinsics and narrowed with round-to-nearest-even,
// which is how the reference casts (``astype``) too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with the Python wrappers (kernels/_build.py DTYPE_CODES)
enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

// route codes of the prefill attention kernels, chosen by the Python
// wrappers (kernels/flash_attention.py ROUTE_CODES): the CUDA-core tile or
// the tensor cores.  The C entry points launch the route they are given
// and refuse inputs it cannot take.
enum { ROUTE_TILE = 0, ROUTE_WGMMA = 1 };

// the reference's "masked" score value
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The reference rounds the softmax weights p to the value dtype before the
// P.V product (decode_attention.py:172, flash_attention.py:154); the
// kernels do the same so that bf16 results track the plain version.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Opt a kernel in to more than 48 KB of dynamic shared memory when it needs
// it (Hopper allows up to 227 KB per block).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
