// K3 -- the fused single-pass flash-attention backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dtf_tpu/ops/flash_attention.py `_dfused_kernel`
// (launched by `_pallas_backward(fused=True)`): dq, dk and dv from one
// walk of the tile space, so S and dP are recomputed once per tile (5
// tile products to the split pair's 7), with the numerics of `_bwd_tile`
// (bwd_tile.cuh).
//
// The TPU kernel sums dq across the outer key dimension in a
// whole-sequence [Sq, D] f32 VMEM scratch (1 MB at S 2048, D 128).
// Hopper has 227 KB of shared memory per block and runs blocks in no
// order, so that scratch has no counterpart.  Instead:
//   pass 1 -- one block per (key tile, batch-head), the K2b walk
//             (bwd_tile.cuh kv_block_kernel<..., true>): dk and dv in
//             registers, and each live query tile's dq contribution from
//             the block's keys written to the block's own f32 slot of
//             `dq_partial` [Sk / 32, B*H, Sq, D];
//   pass 2 -- dq_reduce sums, for each dq element, the slots that were
//             written (under causal masking the key tiles at or before
//             the element's query tile) in slot order, and stores dq in
//             q's dtype.
// One writer per slot and a fixed summation order: no atomics, the same
// bits on every run (crash-resume and elastic runs pin bit-identical
// losses).
//
// What bounds it on the card: operations, as for K2a/K2b -- the f32 FMA
// rate of the CUDA cores in this first version.  The partial buffer adds
// bytes the TPU kernel never moved: at B 8, S 2048, H 6, D 128 it holds
// 64 slots x 48 x 2048 x 128 f32 = 3.2 GB, of which the causal half is
// written once and read once.
//
// Layout as in flash_bwd.cu.
#include "bwd_tile.cuh"

namespace {

using namespace dtf;

constexpr int RT = 256;  // threads per block of the reduce pass

template <typename T, int D>
__global__ void __launch_bounds__(RT)
dq_reduce_kernel(const float* __restrict__ partial, T* __restrict__ dq,
                 int BH, int H, int Sq, int slots, int causal) {
  constexpr int V4 = D / 4;
  const size_t idx = static_cast<size_t>(blockIdx.x) * RT + threadIdx.x;
  if (idx >= static_cast<size_t>(BH) * Sq * V4) return;
  const int c = static_cast<int>(idx % V4) * 4;
  const size_t row = idx / V4;                // bh * Sq + qi
  const int qi = static_cast<int>(row % Sq);
  const int bh = static_cast<int>(row / Sq);
  // key tile t wrote this row's query tile iff it is live there: under
  // causal masking t <= qi / BT (tiles of queries and keys have one size)
  const int last = causal ? min(slots - 1, qi / BT) : slots - 1;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t stride = static_cast<size_t>(BH) * Sq * D;
  const float* src = partial + row * D + c;
  for (int t = 0; t <= last; ++t) {
    const float4 x = *reinterpret_cast<const float4*>(src + t * stride);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const int b = bh / H;
  const int h = bh % H;
  T* out = dq + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D + c;
  store<T>(out, sum.x);
  store<T>(out + 1, sum.y);
  store<T>(out + 2, sum.z);
  store<T>(out + 3, sum.w);
}

template <typename T, int D>
cudaError_t launch_fused(const void* q, const void* k, const void* v,
                         const void* dO, const float* lse2,
                         const float* delta, void* dq, void* dk, void* dv,
                         float* partial, int B, int H, int Sq, int Sk,
                         int causal, float scale, float scale_log2e,
                         cudaStream_t stream) {
  cudaError_t err = launch_kv_blocks<T, D, true>(
      q, k, v, dO, lse2, delta, dk, dv, partial, B, H, Sq, Sk, causal, scale,
      scale_log2e, stream);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * Sq * (D / 4);
  const int slots = (Sk + BT - 1) / BT;
  dq_reduce_kernel<T, D><<<static_cast<unsigned>((n + RT - 1) / RT), RT,
                           0, stream>>>(
      partial, static_cast<T*>(dq), B * H, H, Sq, slots, causal);
  return cudaGetLastError();
}

}  // namespace

// f32 floats the caller allocates for `partial`: ceil(Sk / 32) slots of
// [B*H, Sq, D].
extern "C" long long dtf_flash_bwd_fused_partial_floats(int B, int H, int Sq,
                                                        int Sk, int D) {
  return static_cast<long long>((Sk + dtf::BT - 1) / dtf::BT) * B * H * Sq * D;
}

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128.  Runs both passes on
// `stream`; returns the first failing launch's cudaError_t.
extern "C" int dtf_flash_bwd_fused(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const float* lse2, const float* delta,
                                   void* dq, void* dk, void* dv,
                                   float* partial, int B, int H, int Sq,
                                   int Sk, int D, int dtype, int causal,
                                   float scale, float scale_log2e,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DTF_FUSED(T, DD)                                                  \
  return launch_fused<T, DD>(q, k, v, dO, lse2, delta, dq, dk, dv,       \
                             partial, B, H, Sq, Sk, causal, scale,        \
                             scale_log2e, s)
  if (dtype == 0 && D == 64) DTF_FUSED(float, 64);
  if (dtype == 0 && D == 128) DTF_FUSED(float, 128);
  if (dtype == 1 && D == 64) DTF_FUSED(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) DTF_FUSED(__nv_bfloat16, 128);
#undef DTF_FUSED
  return cudaErrorInvalidValue;
}
