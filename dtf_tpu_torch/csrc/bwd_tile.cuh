// Tile math shared by the flash-backward kernels.  pair_grad is the
// per-pair step of every backward route: the float32 split-product
// kernels K2a (flash_bwd_dq_x3.cuh), K2b and K3 (flash_bwd_x3.cuh), and
// the bfloat16 tensor-core kernels (flash_bwd_dq_tc.cuh,
// flash_bwd_tc.cuh), which round dS to bf16 as they pack it into wgmma
// operands.
//
// The numerics are those of dtf_tpu/ops/flash_attention.py `_bwd_tile`,
// per (query, key) pair:
//   s2 = q.k * (scale * log2 e), set to NEG_INF where the key lies past
//        the query -- on tiles the diagonal crosses only;
//   p  = exp2(s2 - lse2), lse2 = lse * log2 e, computed by the caller;
//   dp = dO.v;
//   dS = p (dp - delta) scale, rounded to T before either product;
// dq += dS K, dk += dS^T Q, dv += P~^T dO with P~ = p rounded to T, all
// summed in f32.  Rows or keys past the sequence get p = 0 and so add
// nothing.
#pragma once

#include "attn_tile.cuh"

namespace dtf {

// p and dS of one (query, key) pair from its f32 dot products.
// `masked`: the key lies past the query on a tile the diagonal crosses;
// `live`: both the row and the key lie inside their sequences.
template <typename T>
__device__ __forceinline__ void pair_grad(float qk, float dp, float lse2,
                                          float delta, bool masked,
                                          bool live, float scale,
                                          float scale_log2e, float& p,
                                          float& ds) {
  const float s2 = masked ? NEG_INF : qk * scale_log2e;
  p = live ? exp2f(s2 - lse2) : 0.f;
  ds = round_as<T>(p * (dp - delta) * scale);
}

}  // namespace dtf
