// Scalar helpers every attention kernel shares: NEG_INF, the 16-byte
// vector load widened to f32, rounding a probability to the value dtype,
// and the store of an f32 result in the output dtype.
//
// The carry rule they serve is dtf_tpu_torch/ops/blockwise.py
// block_accumulate: scores in f32, an additive NEG_INF bias for masked
// keys (finite, so a masked score never makes inf - inf = nan), the
// running max clamped to NEG_INF before exp, the probabilities rounded to
// the value dtype before P.V (the bf16 trade the TPU kernels make), the
// denominator summed from the unrounded probabilities.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtf {

constexpr float NEG_INF = -1e30f;

// 16-byte vector load of VEC = 16 / sizeof(T) elements, widened to f32.
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// x rounded to T and back: what `p.astype(v.dtype)` does to a
// probability before the P.V product.
template <typename T> __device__ __forceinline__ float round_as(float x);
template <> __device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ void store(T* p, float x);
template <> __device__ __forceinline__ void store<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float x) {
  *p = __float2bfloat16(x);
}

}  // namespace dtf
