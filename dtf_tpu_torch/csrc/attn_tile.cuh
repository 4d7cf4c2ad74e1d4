// Tile math of the paged decode kernel (paged_decode.cu): loading
// [rows, D] tiles into shared memory as f32, and folding one key tile
// into a row's online-softmax carry.  NEG_INF, round_as and store serve
// every attention kernel.
//
// The carry rule is dtf_tpu_torch/ops/blockwise.py block_accumulate:
// scores in f32, an additive NEG_INF bias for masked keys (finite, so a
// masked score never makes inf - inf = nan), the running max clamped
// to NEG_INF before exp, the probabilities rounded to the value dtype
// before P.V (the bf16 trade the TPU kernels make), the denominator
// summed from the unrounded probabilities.
//
// Thread layout: NT threads per block, TPR = NT / BQ consecutive lanes
// per query row (TPR <= 32, so a row lives inside one warp and its
// reductions are shuffles).  Lane `sub` of a row owns keys
// sub + i * TPR of the tile and output columns sub + c * TPR: both
// interleavings put the lanes of a row on neighbouring shared-memory
// banks.  Rows are padded by one float (D + 1, BK + 1) so that the
// rows a warp reads in one instruction fall on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtf {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;  // threads per block

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

// Shared-memory floats one block needs for a BQ x BK tile pair.
template <int D, int BQ, int BK>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
}

// Copy ROWS rows of D elements into dst[ROWS][D + 1] as f32.  Row i
// comes from row_ptr(i), which returns nullptr for an absent row; absent
// rows are zero-filled, so the P.V loop multiplies 0 by 0 there, never
// by whatever memory lies past the tensor.
template <typename T, int D, int ROWS, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, RowPtr row_ptr) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;  // vectors per row
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    float vals[VEC];
    const T* src = row_ptr(r);
    if (src != nullptr) {
      load_vec(src + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
    float* d = dst + r * (D + 1) + c;
#pragma unroll
    for (int e = 0; e < VEC; ++e) d[e] = vals[e];
  }
}

// Per-thread carry of one query row: CPT output columns, plus the
// row's running max m and denominator l (replicated on the row's lanes).
template <int D, int BQ>
struct Carry {
  static constexpr int TPR = NT / BQ;
  static constexpr int CPT = D / TPR;
  float o[CPT];
  float m;
  float l;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[c] = 0.f;
    m = NEG_INF;
    l = 0.f;
  }
};

// Fold the key tile k_s/v_s (keys kbase .. kbase + BK - 1) into the carry
// of query row r (lane sub).  A key is admitted iff it is below kend and,
// when `mask` is set, not past qpos.  Every lane of the warp must call
// this (the row reductions are full-warp shuffles).
template <typename T, int D, int BQ, int BK>
__device__ __forceinline__ void accumulate_tile(
    Carry<D, BQ>& carry, const float* q_s, const float* k_s,
    const float* v_s, float* p_s, int r, int sub, int kbase, int kend,
    int qpos, bool mask, float scale) {
  constexpr int TPR = NT / BQ;
  constexpr int KPT = BK / TPR;
  constexpr int CPT = D / TPR;
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  static_assert(TPR <= 32 && 32 % TPR == 0, "a row must fit in a warp");
  static_assert(BK % TPR == 0 && D % TPR == 0, "tile must split evenly");

  float s[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) s[i] = 0.f;
  const float* qr = q_s + r * LD;
  for (int d = 0; d < D; ++d) {
    const float qd = qr[d];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      s[i] = fmaf(qd, k_s[(sub + i * TPR) * LD + d], s[i]);
    }
  }

  float mt = NEG_INF;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int kp = kbase + sub + i * TPR;
    float x = s[i] * scale;
    if (kp >= kend || (mask && kp > qpos)) x += NEG_INF;
    s[i] = x;
    mt = fmaxf(mt, x);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
  }
  const float m_new = fmaxf(carry.m, mt);
  const float m_safe = fmaxf(m_new, NEG_INF);
  const float corr = expf(carry.m - m_safe);

  float ls = 0.f;
  float* pr = p_s + r * LDP;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const float p = expf(s[i] - m_safe);
    ls += p;
    pr[sub + i * TPR] = round_as<T>(p);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    ls += __shfl_xor_sync(0xffffffffu, ls, off);
  }
  carry.l = carry.l * corr + ls;
  carry.m = m_new;
#pragma unroll
  for (int c = 0; c < CPT; ++c) carry.o[c] *= corr;

  __syncwarp();  // the row's probabilities are written by its own warp
  for (int j = 0; j < BK; ++j) {
    const float pj = pr[j];
    const float* vr = v_s + j * LD + sub;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      carry.o[c] = fmaf(pj, vr[c * TPR], carry.o[c]);
    }
  }
}

// True when the warp holding this thread has at least one row below
// `live_rows` of the tile: warps whose rows are all dead skip the math
// (the skip is warp-uniform, so the shuffles stay legal).
template <int BQ>
__device__ __forceinline__ bool warp_has_live_row(int live_rows) {
  constexpr int TPR = NT / BQ;
  return (threadIdx.x / 32) * (32 / TPR) < live_rows;
}

}  // namespace dtf
