// K1 -- flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dtf_tpu/ops/flash_attention.py `_fwd_kernel`
// (launched by `_pallas_forward`): causal or full softmax(Q K^T scale) V
// with the online-softmax carry (o, m, l) kept in f32 on chip, dead
// causal tiles skipped, the mask applied only to tiles the diagonal
// crosses, and o (input dtype) plus lse = max(m, NEG_INF) + log(l or 1)
// (natural log, f32) written out.
//
// Two routes, by dtype, both on the tensor cores and neither falling
// back to the other:
//   bfloat16 -- flash_fwd_tc.cuh (wgmma, cp.async ring, 128-byte
//     swizzle): bf16 operands, f32 sums, P rounded to bf16 before P.V;
//   float32 -- flash_fwd_x3.cuh (mma.sync TF32, cp.async K/V slots): every
//     product an f32-accurate split product, hi + lo TF32 halves of each
//     operand and three TF32 products (tf32x3.cuh).  A product term
//     comes out within about 7e-7 of its exact value (f32 keeps 6e-8),
//     and the tensor core's truncating sums run in chains of at most
//     two k8 slices, each folded into an f32 sum with rounded adds: the
//     route stays inside 1e-5 of the exact plain version, so f32
//     serving stays token-exact.  A single TF32 product would keep
//     three digits and is never used here.
//
// What bounds it on the card: at the serving and training shapes (S <=
// 2048, D = 128) attention is O(S^2 D) work over O(S D) bytes, so it is
// bound by operations -- 989 TFLOP/s on the bf16 route, 165 TFLOP/s of
// f32-accurate work on the f32 route (495 TFLOP/s of TF32 over the
// split's three products).  Both keep the O(S^2) score matrix out of
// device memory, which is what the TPU kernel was for.
//
// Layout: q, k, v, o are [B, S, H, D] contiguous; lse is [B*H, Sq].
// Ragged Sq/Sk are masked in the kernels, not rejected.
#include "flash_fwd_tc.cuh"
#include "flash_fwd_x3.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int dtf_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int H, int Sq,
                             int Sk, int D, int dtype, int causal,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) {
    return dtf::x3::launch_fwd_x3<64>(q, k, v, o, lse, B, H, Sq, Sk, causal,
                                      scale, s);
  }
  if (dtype == 0 && D == 128) {
    return dtf::x3::launch_fwd_x3<128>(q, k, v, o, lse, B, H, Sq, Sk, causal,
                                       scale, s);
  }
  if (dtype == 1 && D == 64) {
    return dtf::tc::launch_fwd_tc<64>(q, k, v, o, lse, B, H, Sq, Sk, causal,
                                      scale, s);
  }
  if (dtype == 1 && D == 128) {
    return dtf::tc::launch_fwd_tc<128>(q, k, v, o, lse, B, H, Sq, Sk, causal,
                                       scale, s);
  }
  return cudaErrorInvalidValue;
}
