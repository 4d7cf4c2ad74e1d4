// K1, bf16 route -- the flash attention forward on Hopper's tensor cores.
//
// Replaces, for bf16 inputs, the TPU kernel dtf_tpu/ops/flash_attention.py
// `_fwd_kernel` (launched by `_pallas_forward`); float32 inputs take
// `flash_fwd_x3_kernel` (flash_fwd_x3.cuh), whose products are
// f32-accurate split TF32 products.  The function
// is the one of blockwise.py block_accumulate: scores in f32, the
// additive NEG_INF bias on masked keys (only on tiles the causal
// diagonal or the ragged key end crosses), the running max clamped to
// NEG_INF before exp, P rounded to bf16 before P.V, the denominator
// summed from the unrounded P; o in bf16 and lse = max(m, NEG_INF) +
// log(l or 1) in f32.  The exponentials are taken in base 2, exp(x) =
// exp2(x log2 e), with the scores and the running max carried times
// log2 e.
//
// What bounds it on the card: operations.  At the training shape
// [8, 2048, 6, 128], causal, the two tile products are 5.2e10 flop --
// 0.052 ms at 989 TFLOP/s -- over 25 MB of inputs and outputs.  So both
// products are wgmma (m64n64k16 for S = Q K^T with Q and K from shared
// memory, m64nDk16 for O += P V with P from registers and V read
// MN-major through the transpose bit), and the f32 accumulators never
// leave registers: S's accumulator layout is the A-fragment layout, so
// P goes from the softmax straight into the second product.
//
// Design.  A block of two warpgroups owns 128 query rows of one
// batch-head (64 rows a warpgroup) and walks 64-key K/V tiles through a
// two-stage cp.async ring in 128-byte-swizzled shared memory (hopper.cuh):
// the copies of tile t + 1 run while tile t is multiplied.  Causal
// tiles past a warpgroup's last row are skipped, by the warpgroup.
// Copies are cp.async rather than TMA (see hopper.cuh); there is no
// producer warp -- every thread issues its share of the copies.
//
// Layout: q, k, v, o [B, S, H, D] contiguous bf16, D 64 or 128; lse
// [B*H, Sq] f32.  Grid (B*H, ceil(Sq / 128)).  Ragged Sq and Sk are
// masked here: rows past a sequence are zero-filled in shared memory,
// keys past Sk get the NEG_INF bias, rows past Sq are not stored.
#pragma once

#include "attn_tile.cuh"
#include "hopper.cuh"

namespace dtf {
namespace tc {

constexpr int FWD_BQ = 128;  // query rows per block, 64 per warpgroup
constexpr int FWD_BK = 64;   // keys per K/V tile
constexpr int FWD_NT = 256;  // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr int fwd_smem_bytes() {
  // the Q tile, two stages of K and V tiles, and slack to align to 1024
  return FWD_BQ * D * 2 + 2 * 2 * FWD_BK * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(FWD_NT, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int Sq, int Sk,
                    int causal, float scale) {
  constexpr int Q_BYTES = FWD_BQ * D * 2;
  constexpr int KV_BYTES = FWD_BK * D * 2;
  constexpr int PANEL_Q = FWD_BQ * 128;   // bytes of a 64-column panel
  constexpr int PANEL_KV = FWD_BK * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  // stage s of the ring: K at kv_s + 2 s KV_BYTES, V right after it
  const uint32_t kv_s = q_s + Q_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // blocks start in order of blockIdx, x fastest: the last query tiles,
  // the longest under causal masking, go first, for every batch-head
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_BQ;
  const float scale_log2e = scale * LOG2E;
  const size_t stride = static_cast<size_t>(H) * D;
  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;

  // causal: keys past the block's last query are dead for every row
  const int q_last = min(q0 + FWD_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + FWD_BK - 1) / FWD_BK;

  load_rows<FWD_BQ, D, FWD_NT>(q_s, qb, stride, q0, Sq, tid);
  load_rows<FWD_BK, D, FWD_NT>(kv_s, kb, stride, 0, Sk, tid);
  load_rows<FWD_BK, D, FWD_NT>(kv_s + KV_BYTES, vb, stride, 0, Sk, tid);
  cp_async_commit();

  // this warpgroup's 64 query rows, and this thread's two of them
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 63, Sq - 1);
  int qrow[2];
  qrow[0] = wq0 + 16 * warp + lane / 4;
  qrow[1] = qrow[0] + 8;
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t k_s = kv_s + (t % 2) * 2 * KV_BYTES;
    const uint32_t v_s = k_s + KV_BYTES;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t is in; every warpgroup is done with t - 1
    if (t + 1 < n_tiles) {
      const uint32_t next = kv_s + ((t + 1) % 2) * 2 * KV_BYTES;
      load_rows<FWD_BK, D, FWD_NT>(next, kb, stride, (t + 1) * FWD_BK, Sk,
                                   tid);
      load_rows<FWD_BK, D, FWD_NT>(next + KV_BYTES, vb, stride,
                                   (t + 1) * FWD_BK, Sk, tid);
      cp_async_commit();
    }
    const int k0 = t * FWD_BK;
    // warpgroup-uniform: no row of this warpgroup sees a key of the tile
    if (wq0 >= Sq || (causal && k0 > wq_last)) continue;

    // S = Q K^T, [64 rows, 64 keys], over D in k16 steps
    float s[FWD_BK / 2];
#pragma unroll
    for (int i = 0; i < FWD_BK / 2; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t along = (ks % 4) * 32;  // 16 columns into the panel
      mma_ss_n64<0, 0>(
          s,
          sw128_desc(q_s + (ks / 4) * PANEL_Q + wg * 64 * 128 + along, 16,
                     1024),
          sw128_desc(k_s + (ks / 4) * PANEL_KV + along, 16, 1024), ks > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(s);

    // online softmax over the tile in base 2 (exp(x) = exp2(x log2 e):
    // the scores and the running max are carried times log2 e); a row's
    // four lanes share a quad
    const bool mask = k0 + FWD_BK > Sk || (causal && k0 + FWD_BK - 1 > wq0);
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < FWD_BK / 2; ++i) {
      const int hf = acc_half(i);
      float x = s[i] * scale_log2e;
      if (mask) {
        const int kp = k0 + acc_col(i, lane);
        if (kp >= Sk || (causal && kp > qrow[hf])) x += NEG_INF;
      }
      s[i] = x;
      mt[hf] = fmaxf(mt[hf], x);
    }
    float m_safe[2];
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 1));
      mt[hf] = fmaxf(mt[hf], __shfl_xor_sync(0xffffffffu, mt[hf], 2));
      const float m_new = fmaxf(m[hf], mt[hf]);
      m_safe[hf] = fmaxf(m_new, NEG_INF);
      corr[hf] = exp2f(m[hf] - m_safe[hf]);
      m[hf] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < FWD_BK / 2; ++i) {
      const int hf = acc_half(i);
      const float p = exp2f(s[i] - m_safe[hf]);
      ls[hf] += p;
      s[i] = p;
    }
    uint32_t pa[FWD_BK / 16][4];
    pack_a<FWD_BK>(s, pa);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      ls[hf] += __shfl_xor_sync(0xffffffffu, ls[hf], 1);
      ls[hf] += __shfl_xor_sync(0xffffffffu, ls[hf], 2);
      l[hf] = l[hf] * corr[hf] + ls[hf];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[acc_half(i)];

    // O += P V: P from registers, V [64 keys, D] read MN-major
    pin(o_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_BK / 16; ++kk) {
      mma_rs<D, 1>(o_acc, pa[kk],
                   sw128_desc(v_s + kk * 16 * 128, PANEL_KV, 1024), 1);
    }
    wg_commit();
    wg_wait_all();
    pin(o_acc);
    pin(pa);
  }

  if (wq0 >= Sq) return;
  bf16* ob = o + (static_cast<size_t>(b) * Sq * H + h) * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = qrow[hf];
    if (qi >= Sq) continue;
    const float denom = l[hf] == 0.f ? 1.f : l[hf];
    bf16* orow = ob + static_cast<size_t>(qi) * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i0 = 4 * j + 2 * hf;
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * (lane % 4)) =
          pack_bf16(o_acc[i0] / denom, o_acc[i0 + 1] / denom);
    }
    if (lane % 4 == 0) {
      // back to natural log; a row no key reached keeps NEG_INF
      const float m_nat = m[hf] > NEG_INF ? m[hf] * LN2 : NEG_INF;
      lse[static_cast<size_t>(bh) * Sq + qi] = m_nat + logf(denom);
    }
  }
}

template <int D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int Sq, int Sk,
                          int causal, float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + FWD_BQ - 1) / FWD_BQ);
  kernel<<<grid, FWD_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, Sq, Sk,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace dtf
