// Second pass of the split-K int4 paged decode kernel
// (paged_decode_attention_q4.cu): one block per (sequence b, kv head h)
// rescales the splits that hold tokens to their common max, sums them in
// order (deterministic, no atomics), divides by l (clamped at 1e-30, as the
// reference does) and writes the result in the output dtype.
//
// part_acc [B,Hkv,n_split,G,D] holds each split's unnormalised accumulator,
// part_ml [B,Hkv,n_split,G,2] its running max m and denominator l; splits
// at or past lengths[b] were never written and are not read.
#pragma once

#include "common.cuh"

template <typename T>
__global__ void paged_decode_combine(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml,
                                     const int* __restrict__ lengths,
                                     T* __restrict__ out, int H, int Hkv, int D, int P,
                                     int W, int split, int n_split) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = H / Hkv;
  const int len = min(lengths[b], W * P);
  const int used = min((len + split - 1) / split, n_split);
  const size_t base = (static_cast<size_t>(b) * Hkv + h) * n_split;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float m = NEG_INF;
    for (int z = 0; z < used; ++z) m = fmaxf(m, part_ml[((base + z) * G + g) * 2]);
    float l = 0.f, a = 0.f;
    for (int z = 0; z < used; ++z) {
      const float w = expf(part_ml[((base + z) * G + g) * 2] - m);
      l += w * part_ml[((base + z) * G + g) * 2 + 1];
      a += w * part_acc[(base + z) * G * D + i];
    }
    out[(static_cast<size_t>(b) * H + h * G) * D + i] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}
