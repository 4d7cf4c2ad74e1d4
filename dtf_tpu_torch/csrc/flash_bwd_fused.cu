// K3 -- the fused single-pass flash-attention backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dtf_tpu/ops/flash_attention.py `_dfused_kernel`
// (launched by `_pallas_backward(fused=True)`): dq, dk and dv from one
// walk of the tile space, so S and dP are recomputed once per tile (5
// tile products to the split pair's 7), with the numerics of `_bwd_tile`
// (bwd_tile.cuh pair_grad).
//
// Two routes, by dtype, both on the tensor cores and neither falling
// back to the other, both walking 128-key blocks:
//   bfloat16 -- flash_bwd_tc.cuh bwd_fused_tc_kernel + dq_reduce_tc_kernel
//     (wgmma, bf16 operands, f32 sums);
//   float32 -- flash_bwd_x3.cuh bwd_fused_x3_kernel + dq_reduce_x3_kernel
//     (mma.sync TF32): every product an f32-accurate split product, hi +
//     lo TF32 halves of each operand and three TF32 products
//     (tf32x3.cuh).  A product term comes out within about 7e-7 of its
//     exact value, and the tensor core's truncating sums run in chains
//     of at most four k8 slices, each folded into an f32 sum with
//     rounded adds, so dk and dv -- sums over up to S rows -- drift no
//     more than f32 sums do: the route stays inside the 1e-5 (scaled)
//     gate against the exact plain version and against the split pair
//     K2a/K2b, whose f32 route is split TF32 too.  A single TF32 product
//     would keep three digits and is never used here.
//
// The TPU kernel sums dq across the outer key dimension in a
// whole-sequence [Sq, D] f32 VMEM scratch (1 MB at S 2048, D 128).
// Hopper has 227 KB of shared memory per block and runs blocks in no
// order, so that scratch has no counterpart.  Instead, on both routes:
//   pass 1 -- one block per (batch-head, 128-key block): dk and dv in
//             registers, and each live query tile's dq contribution from
//             the block's keys written to the block's own f32 slot of
//             `dq_partial` [ceil(Sk / 128), B*H, Sq, D];
//   pass 2 -- sums, for each dq element, the slots that were written
//             (under causal masking the key blocks at or before the
//             element's row) in slot order, and stores dq in q's dtype.
// One writer per slot and a fixed summation order: no atomics, the same
// bits on every run (crash-resume and elastic runs pin bit-identical
// losses).
//
// What bounds it on the card: operations -- 989 TFLOP/s on the bf16
// route, 165 TFLOP/s of f32-accurate work on the f32 route (495 TFLOP/s
// of TF32 over the split's three products).  The partial buffer adds
// bytes the TPU kernel never moved: at B 8, S 2048, H 6, D 128 it holds
// 16 slots x 48 x 2048 x 128 f32 = 0.81 GB, of which the causal half is
// written once and read once.
//
// Layout as in flash_bwd.cu.
#include "flash_bwd_tc.cuh"
#include "flash_bwd_x3.cuh"

// f32 floats the caller allocates for `partial`: one [B*H, Sq, D] slot
// per 128-key block on both routes (the wrapper's
// ops/flash_attention.py fused_partial_floats computes the same).
extern "C" long long dtf_flash_bwd_fused_partial_floats(int B, int H, int Sq,
                                                        int Sk, int D,
                                                        int dtype) {
  (void)dtype;
  const long long slots = dtf::tc::bwd_slots(Sk);
  return slots * B * H * Sq * D;
}

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128.  `partial_floats` is
// the size of `partial` as allocated.  Runs both passes on `stream`;
// returns the first failing launch's cudaError_t.
extern "C" int dtf_flash_bwd_fused(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const float* lse2, const float* delta,
                                   void* dq, void* dk, void* dv,
                                   float* partial, long long partial_floats,
                                   int B, int H, int Sq, int Sk, int D,
                                   int dtype, int causal, float scale,
                                   float scale_log2e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partial_floats <
      dtf_flash_bwd_fused_partial_floats(B, H, Sq, Sk, D, dtype)) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0 && D == 64) {
    return dtf::x3::launch_bwd_fused_x3<64>(
        q, k, v, dO, lse2, delta, dq, dk, dv, partial, B, H, Sq, Sk, causal,
        scale, scale_log2e, s);
  }
  if (dtype == 0 && D == 128) {
    return dtf::x3::launch_bwd_fused_x3<128>(
        q, k, v, dO, lse2, delta, dq, dk, dv, partial, B, H, Sq, Sk, causal,
        scale, scale_log2e, s);
  }
  if (dtype == 1 && D == 64) {
    return dtf::tc::launch_bwd_fused_tc<64>(
        q, k, v, dO, lse2, delta, dq, dk, dv, partial, B, H, Sq, Sk, causal,
        scale, scale_log2e, s);
  }
  if (dtype == 1 && D == 128) {
    return dtf::tc::launch_bwd_fused_tc<128>(
        q, k, v, dO, lse2, delta, dq, dk, dv, partial, B, H, Sq, Sk, causal,
        scale, scale_log2e, s);
  }
  return cudaErrorInvalidValue;
}
