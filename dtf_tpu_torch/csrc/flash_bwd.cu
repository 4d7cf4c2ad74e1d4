// K2a and K2b -- the split flash-attention backward for Hopper (sm_90a).
//
// Replace the TPU kernels dtf_tpu/ops/flash_attention.py `_dq_kernel`
// (K2a) and `_dkdv_kernel` (K2b), launched by
// `_pallas_backward(fused=False)`, with the numerics of `_bwd_tile`
// (see bwd_tile.cuh): probabilities recomputed per tile from the saved
// base-2 log-sum-exp, dead causal tiles skipped, the mask applied only
// on tiles the diagonal crosses, f32 sums, outputs in the inputs' dtype.
//
// Two routes inside each C entry point, by dtype, both on the tensor
// cores and neither falling back to the other:
//   bfloat16 -- wgmma with a cp.async ring: K2a bwd_dq_tc_kernel
//     (flash_bwd_dq_tc.cuh), query-major, 128 rows a block; K2b
//     bwd_dkdv_tc_kernel (flash_bwd_tc.cuh), K3's key-major walk without
//     its dq product, 128 keys a block;
//   float32 -- mma.sync TF32 in f32-accurate split products, hi + lo
//     TF32 halves of each operand and three TF32 products (tf32x3.cuh):
//     K2a bwd_dq_x3_kernel (flash_bwd_dq_x3.cuh), query-major, 128 rows
//     a block; K2b bwd_dkdv_x3_kernel (flash_bwd_x3.cuh), K3's f32 walk
//     without its dq product.  A product term comes out within about
//     7e-7 of its exact value, and the tensor core's truncating sums run
//     in short chains, each folded into an f32 sum with rounded adds, so
//     the route stays inside the 1e-5 (scaled) gate against the exact
//     plain versions.  A single TF32 product would keep three digits and
//     is never used here.
// Every output row has one writer on both routes, so no atomics and the
// same bits on every run.
//
// What bounds them on the card: at the training shape (S 2048, D 128)
// the backward is O(S^2 D) work over O(S D) bytes, so operations bound
// it -- 989 TFLOP/s on the bf16 route, 165 TFLOP/s of f32-accurate work
// on the f32 route (495 TFLOP/s of TF32 over the split's three
// products).  The split pair recomputes S and dP in both kernels (7
// tile products to K3's 5), and in exchange needs no dq slots.
//
// Layout: q, dO, dq [B, Sq, H, D] and k, v, dk, dv [B, Sk, H, D]
// contiguous; lse2 (the forward's lse times log2 e) and delta =
// rowsum(dO * o) are [B*H, Sq] f32.  Ragged Sq and Sk, and Sq != Sk, are
// masked in the kernels; positions count from 0 for queries and keys
// alike.
#include "flash_bwd_dq_tc.cuh"
#include "flash_bwd_dq_x3.cuh"
#include "flash_bwd_tc.cuh"
#include "flash_bwd_x3.cuh"

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128.  Each returns the
// launch's cudaError_t.
extern "C" int dtf_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dO, const float* lse2,
                                const float* delta, void* dq, int B, int H,
                                int Sq, int Sk, int D, int dtype, int causal,
                                float scale, float scale_log2e,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) {
    return dtf::x3::launch_bwd_dq_x3<64>(q, k, v, dO, lse2, delta, dq, B, H,
                                         Sq, Sk, causal, scale, scale_log2e,
                                         s);
  }
  if (dtype == 0 && D == 128) {
    return dtf::x3::launch_bwd_dq_x3<128>(q, k, v, dO, lse2, delta, dq, B,
                                          H, Sq, Sk, causal, scale,
                                          scale_log2e, s);
  }
  if (dtype == 1 && D == 64) {
    return dtf::tc::launch_bwd_dq_tc<64>(q, k, v, dO, lse2, delta, dq, B, H,
                                         Sq, Sk, causal, scale, scale_log2e,
                                         s);
  }
  if (dtype == 1 && D == 128) {
    return dtf::tc::launch_bwd_dq_tc<128>(q, k, v, dO, lse2, delta, dq, B,
                                          H, Sq, Sk, causal, scale,
                                          scale_log2e, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int dtf_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const void* dO,
                                  const float* lse2, const float* delta,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Sk, int D, int dtype, int causal,
                                  float scale, float scale_log2e,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) {
    return dtf::x3::launch_bwd_dkdv_x3<64>(q, k, v, dO, lse2, delta, dk, dv,
                                           B, H, Sq, Sk, causal, scale,
                                           scale_log2e, s);
  }
  if (dtype == 0 && D == 128) {
    return dtf::x3::launch_bwd_dkdv_x3<128>(q, k, v, dO, lse2, delta, dk,
                                            dv, B, H, Sq, Sk, causal, scale,
                                            scale_log2e, s);
  }
  if (dtype == 1 && D == 64) {
    return dtf::tc::launch_bwd_dkdv_tc<64>(q, k, v, dO, lse2, delta, dk, dv,
                                           B, H, Sq, Sk, causal, scale,
                                           scale_log2e, s);
  }
  if (dtype == 1 && D == 128) {
    return dtf::tc::launch_bwd_dkdv_tc<128>(q, k, v, dO, lse2, delta, dk, dv,
                                            B, H, Sq, Sk, causal, scale,
                                            scale_log2e, s);
  }
  return cudaErrorInvalidValue;
}
