// K2a, bf16 route -- the split flash backward's dq on Hopper's tensor
// cores.
//
// Replaces, for bf16 inputs, the TPU kernel dtf_tpu/ops/flash_attention.py
// `_dq_kernel` (launched by `_pallas_backward(fused=False)`); float32
// inputs take the CUDA-core flash_bwd_dq_kernel (flash_bwd.cu), exact in
// f32.  The numerics are `_bwd_tile`'s (bwd_tile.cuh pair_grad, as in
// K3 and K2b, flash_bwd_tc.cuh): p = exp2(q.k scale log2 e - lse log2 e),
// the mask as a replacement by NEG_INF, dS = p (dp - delta) scale
// rounded to bf16 before the dq product, f32 sums, dq stored in bf16.
//
// What bounds it on the card: operations.  Three tile products per live
// (query, key) pair -- S, dP and dQ -- are 7.7e10 flop at the training
// shape [8, 2048, 6, 128], causal: 0.078 ms at 989 TFLOP/s.  All three
// are wgmma with f32 accumulators, shaped like K1 (flash_fwd_tc.cuh):
//   S   = Q K^T     m64n64k16, Q and K K-major from shared memory;
//   dP  = dO V^T    likewise;
//   dQ += dS K      A = dS from registers (the S accumulator's layout is
//                   the A-fragment layout), K [64 keys, D] read MN-major
//                   through the transpose bit, as K1 reads V for P V.
//
// Design.  Query-major: a block of two warpgroups owns 128 query rows
// of one batch-head (64 a warpgroup).  Its Q and dO tiles stay in
// 128-byte-swizzled shared memory (hopper.cuh) for the whole walk, each
// thread keeps the lse2 and delta of its two rows in registers, and
// 64-key K/V tiles flow through a two-stage cp.async ring: the copies of
// tile t + 1 run while tile t is multiplied.  A warpgroup's dQ, [64, D]
// f32, stays in registers for the whole walk and is stored once in
// bf16: one writer per dq tile, no slots, no reduce pass, no atomics,
// the same bits on every run.  Causal tiles past a warpgroup's last row
// are skipped, by the warpgroup; the per-element mask and the ragged
// ends are checked only on tiles the diagonal or a sequence end
// crosses.  Blocks start in order of blockIdx, x fastest: the last
// query tiles, the longest walks under causal masking, go first.
//
// Layout: q, k, v, dO, dq [B, S, H, D] contiguous bf16, D 64 or 128;
// lse2 and delta [B*H, Sq] f32.  Grid (B*H, ceil(Sq / 128)).  Positions
// count from 0 for queries and keys alike, so under causal masking a
// row at or past Sk sees every key.
#pragma once

#include "attn_tile.cuh"
#include "bwd_tile.cuh"
#include "hopper.cuh"

namespace dtf {
namespace tc {

constexpr int DQ_BQ = 128;  // query rows per block, 64 per warpgroup
constexpr int DQ_BK = 64;   // keys per K/V tile
constexpr int DQ_NT = 256;  // two warpgroups

template <int D>
constexpr int dq_smem_bytes() {
  // the Q and dO tiles, two stages of K and V tiles, and slack to align
  // to 1024
  return 2 * DQ_BQ * D * 2 + 2 * 2 * DQ_BK * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(DQ_NT, 1)
bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dO,
                 const float* __restrict__ lse2,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int H, int Sq, int Sk, int causal, float scale,
                 float scale_log2e) {
  constexpr int Q_BYTES = DQ_BQ * D * 2;
  constexpr int KV_BYTES = DQ_BK * D * 2;
  constexpr int PANEL_Q = DQ_BQ * 128;   // bytes of a 64-column panel
  constexpr int PANEL_KV = DQ_BK * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + Q_BYTES;
  // stage s of the ring: K at kv_s + 2 s KV_BYTES, V right after it
  const uint32_t kv_s = do_s + Q_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t q_head = (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;

  // causal: keys past the block's last query are dead for every row
  const int q_last = min(q0 + DQ_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + DQ_BK - 1) / DQ_BK;

  load_rows<DQ_BQ, D, DQ_NT>(q_s, q + q_head, stride, q0, Sq, tid);
  load_rows<DQ_BQ, D, DQ_NT>(do_s, dO + q_head, stride, q0, Sq, tid);
  load_rows<DQ_BK, D, DQ_NT>(kv_s, kb, stride, 0, Sk, tid);
  load_rows<DQ_BK, D, DQ_NT>(kv_s + KV_BYTES, vb, stride, 0, Sk, tid);
  cp_async_commit();

  // this warpgroup's 64 query rows, and this thread's two of them
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 63, Sq - 1);
  int qrow[2];
  qrow[0] = wq0 + 16 * warp + lane / 4;
  qrow[1] = qrow[0] + 8;
  float lse_r[2];
  float delta_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const bool live = qrow[hf] < Sq;
    const size_t at = static_cast<size_t>(bh) * Sq + (live ? qrow[hf] : 0);
    lse_r[hf] = live ? lse2[at] : 0.f;
    delta_r[hf] = live ? delta[at] : 0.f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t k_s = kv_s + (t % 2) * 2 * KV_BYTES;
    const uint32_t v_s = k_s + KV_BYTES;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t is in; every warpgroup is done with t - 1
    if (t + 1 < n_tiles) {
      const uint32_t next = kv_s + ((t + 1) % 2) * 2 * KV_BYTES;
      load_rows<DQ_BK, D, DQ_NT>(next, kb, stride, (t + 1) * DQ_BK, Sk, tid);
      load_rows<DQ_BK, D, DQ_NT>(next + KV_BYTES, vb, stride,
                                 (t + 1) * DQ_BK, Sk, tid);
      cp_async_commit();
    }
    const int k0 = t * DQ_BK;
    // warpgroup-uniform: no row of this warpgroup sees a key of the tile
    if (wq0 >= Sq || (causal && k0 > wq_last)) continue;

    // S = Q K^T and dP = dO V^T: [64 rows, 64 keys] over D
    float s[32];
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t along = (ks % 4) * 32;  // 16 columns into the panel
      const uint32_t q_off = (ks / 4) * PANEL_Q + wg * 64 * 128 + along;
      const uint32_t kv_off = (ks / 4) * PANEL_KV + along;
      mma_ss_n64<0, 0>(s, sw128_desc(q_s + q_off, 16, 1024),
                       sw128_desc(k_s + kv_off, 16, 1024), ks > 0);
      mma_ss_n64<0, 0>(dp, sw128_desc(do_s + q_off, 16, 1024),
                       sw128_desc(v_s + kv_off, 16, 1024), ks > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(dp);

    // dS per (row, key) pair; only tiles the diagonal or a ragged end
    // crosses pay for the per-element checks
    const bool diag = causal && k0 + DQ_BK - 1 > wq0;
    const bool edge = diag || k0 + DQ_BK > Sk || wq0 + 64 > Sq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = acc_half(i);
      const int kj = k0 + acc_col(i, lane);
      const int qi = qrow[hf];
      float p;
      pair_grad<float>(s[i], dp[i], lse_r[hf], delta_r[hf], diag && kj > qi,
                       !edge || (qi < Sq && kj < Sk), scale, scale_log2e, p,
                       dp[i]);
    }
    uint32_t dsa[DQ_BK / 16][4];
    pack_a<DQ_BK>(dp, dsa);

    // dQ += dS K: dS from registers, K [64 keys, D] read MN-major
    pin(dq_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      mma_rs<D, 1>(dq_acc, dsa[kk],
                   sw128_desc(k_s + kk * 16 * 128, PANEL_KV, 1024), 1);
    }
    wg_commit();
    wg_wait_all();
    pin(dq_acc);
    pin(dsa);
  }

  if (wq0 >= Sq) return;
  bf16* dqb = dq + q_head;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = qrow[hf];
    if (qi >= Sq) continue;
    bf16* row = dqb + static_cast<size_t>(qi) * stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i0 = 4 * j + 2 * hf;
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(dq_acc[i0], dq_acc[i0 + 1]);
    }
  }
}

template <int D>
cudaError_t launch_bwd_dq_tc(const void* q, const void* k, const void* v,
                             const void* dO, const float* lse2,
                             const float* delta, void* dq, int B, int H,
                             int Sq, int Sk, int causal, float scale,
                             float scale_log2e, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  auto kernel = bwd_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + DQ_BQ - 1) / DQ_BQ);
  kernel<<<grid, DQ_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse2, delta,
      static_cast<bf16*>(dq), H, Sq, Sk, causal, scale, scale_log2e);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace dtf
