// K3 and K2b, bf16 route -- the key-major flash backward walk on
// Hopper's tensor cores.
//
// One walk, two kernels:
//   bwd_fused_tc_kernel (K3, with dq) replaces, for bf16 inputs, the TPU
//     kernel dtf_tpu/ops/flash_attention.py `_dfused_kernel` (launched by
//     `_pallas_backward(fused=True)`): dq, dk and dv from one walk of the
//     tile space;
//   bwd_dkdv_tc_kernel (K2b, without dq) replaces `_dkdv_kernel`
//     (`_pallas_backward(fused=False)`): dk and dv only.
// Both are bwd_kv_walk<D, DQ>, so they share one copy of the tile
// numerics.  Float32 inputs take the split-product walk of K3 and K2b
// (flash_bwd_x3.cuh).  The numerics are `_bwd_tile`'s
// (bwd_tile.cuh pair_grad): p = exp2(q.k scale log2 e - lse log2 e),
// the mask as a replacement by NEG_INF on tiles the diagonal crosses,
// dS = p (dp - delta) scale rounded to bf16 before its products, P
// rounded to bf16 before the dv product, f32 sums.
//
// What bounds them on the card: operations.  Five tile products per
// live (query, key) pair for K3 -- S, dP, dV, dK and dQ -- four for K2b,
// are 1.3e11 and 1.0e11 flop at the training shape [8, 2048, 6, 128],
// causal: 0.13 and 0.10 ms at 989 TFLOP/s.  All are wgmma with f32
// accumulators:
//   S^T  = K Q^T      m64n64k16, K and Q K-major from shared memory;
//   dP^T = V dO^T     likewise;
//   dV  += P~^T dO    A = P~^T from registers (the S^T accumulator is
//                     already in A-fragment layout), dO read MN-major;
//   dK  += dS^T Q     A = dS^T from registers, Q read MN-major;
//   dQ   = dS K       (K3 only) A = dS read MN-major from shared memory
//                     (dS^T is stored there, queries contiguous), K
//                     MN-major.
// Computing S and dP transposed -- keys as the rows of the product --
// puts dV's and dK's A operands in registers with no shared-memory
// round trip; only K3's dS goes through shared memory, for dQ.
//
// Design.  A block of two warpgroups owns 128 keys of one batch-head
// (64 a warpgroup: its dK and dV, [64, D] f32, stay in registers for
// the whole walk) and walks the live 64-row query tiles; Q, dO and
// their lse / delta rows flow through a two-stage cp.async ring in
// 128-byte-swizzled shared memory (hopper.cuh).  A block whose first
// key lies past every query under causal masking walks nothing and
// writes zeros.
//
// K3's dq: each query tile's dQ over the block's 128 keys is split by
// columns between the warpgroups (D = 128; at D = 64 the first
// warpgroup computes it alone) and written to the block's own f32 slot
// of `dq_partial` [ceil(Sk / 128), B*H, Sq, D]; a second kernel,
// dq_reduce_tc_kernel, sums the slots that were written in slot order
// and stores dq in bf16.  One writer per slot and a fixed order: no
// atomics, the same bits on every run.  At the training shape the slots
// hold 16 x 48 x 2048 x 128 f32 = 0.81 GB, as on the f32 route, about
// half of it written and read under causal masking.  K2b has none of
// this: no dS^T tile in shared memory, no block-wide barrier between
// the dK and dQ products, no slots, no reduce pass (K2a,
// flash_bwd_dq_tc.cuh, computes dq query-major).
//
// Layout: q, k, v, dO, dk, dv [B, S, H, D] bf16, D 64 or 128; lse2 (lse
// times log2 e) and delta [B*H, Sq] f32.  Positions count from 0 for
// queries and keys alike; ragged Sq and Sk are masked here.
#pragma once

#include "attn_tile.cuh"
#include "bwd_tile.cuh"
#include "hopper.cuh"

namespace dtf {
namespace tc {

constexpr int BWD_BK = 128;  // keys per block, 64 per warpgroup
constexpr int BWD_BQ = 64;   // query rows per tile of the walk
constexpr int BWD_NT = 256;  // two warpgroups
constexpr int RED_NT = 256;  // threads per block of the reduce pass

// key blocks of the walk, and K3's dq partial slots: one per 128 keys
__host__ __device__ constexpr int bwd_slots(int Sk) {
  return (Sk + BWD_BK - 1) / BWD_BK;
}

template <int D, bool DQ>
constexpr int bwd_smem_bytes() {
  // K and V tiles, two stages of Q and dO tiles, K3's dS^T, two stages
  // of lse2 and delta rows, and slack to align to 1024
  return 2 * BWD_BK * D * 2 + 2 * 2 * BWD_BQ * D * 2 +
         (DQ ? BWD_BK * BWD_BQ * 2 : 0) + 2 * 2 * BWD_BQ * 4 + 1024;
}

// The walk of one 128-key block; DQ adds K3's dq product and slot write
// (`dq_partial` is unused without it).
template <int D, bool DQ>
__device__ __forceinline__ void bwd_kv_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dq_partial, int H, int Sq, int Sk, int causal,
    float scale, float scale_log2e) {
  constexpr int KV_BYTES = BWD_BK * D * 2;
  constexpr int QT_BYTES = BWD_BQ * D * 2;
  constexpr int DS_BYTES = BWD_BK * BWD_BQ * 2;
  constexpr int PANEL_KV = BWD_BK * 128;  // bytes of a 64-column panel
  constexpr int PANEL_Q = BWD_BQ * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + KV_BYTES;
  // stage s of the ring: Q at st_s + 2 s QT_BYTES, dO right after it
  const uint32_t st_s = v_s + KV_BYTES;
  const uint32_t ds_s = st_s + 4 * QT_BYTES;    // dS^T [128 keys][64 rows]
  uint8_t* ds_ptr = smem_raw + (ds_s - raw);
  // stage s: lse2 at rows + 128 s, delta at rows + 128 s + 64
  float* rows = reinterpret_cast<float*>(ds_ptr + (DQ ? DS_BYTES : 0));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // blocks start in order of blockIdx, x fastest: the first key blocks,
  // the longest walks under causal masking, go first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.y * BWD_BK;
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t q_head = (static_cast<size_t>(b) * Sq * H + h) * D;
  const size_t k_head = (static_cast<size_t>(b) * Sk * H + h) * D;
  const float* lse_b = lse2 + static_cast<size_t>(bh) * Sq;
  const float* delta_b = delta + static_cast<size_t>(bh) * Sq;

  // causal: query tiles that end before the block's first key are dead;
  // k0 is a multiple of the 64-row tile, so the first live tile starts
  // at k0
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = q_begin < Sq ? (Sq - q_begin + BWD_BQ - 1) / BWD_BQ
                                   : 0;

  auto load_q_tile = [&](int t) {
    const int qt0 = q_begin + t * BWD_BQ;
    const uint32_t qs = st_s + (t % 2) * 2 * QT_BYTES;
    load_rows<BWD_BQ, D, BWD_NT>(qs, q + q_head, stride, qt0, Sq, tid);
    load_rows<BWD_BQ, D, BWD_NT>(qs + QT_BYTES, dO + q_head, stride, qt0, Sq,
                                 tid);
    if (tid < 2 * BWD_BQ) {
      const int r = tid % BWD_BQ;
      const bool valid = qt0 + r < Sq;
      const float* src = (tid < BWD_BQ ? lse_b : delta_b) +
                         (valid ? qt0 + r : 0);
      cp_async4(smem_u32(rows + (t % 2) * 2 * BWD_BQ + tid), src, valid);
    }
  };

  load_rows<BWD_BK, D, BWD_NT>(k_s, k + k_head, stride, k0, Sk, tid);
  load_rows<BWD_BK, D, BWD_NT>(v_s, v + k_head, stride, k0, Sk, tid);
  if (n_tiles > 0) load_q_tile(0);
  cp_async_commit();

  // this warpgroup's 64 keys, and this thread's two of them (row of the
  // transposed products)
  const int wk0 = k0 + 64 * wg;
  int krow[2];
  krow[0] = 16 * warp + lane / 4;
  krow[1] = krow[0] + 8;
  float dk_acc[D / 2];
  float dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * BWD_BQ;
    const uint32_t qs = st_s + (t % 2) * 2 * QT_BYTES;
    const uint32_t dos = qs + QT_BYTES;
    const float* lse_t = rows + (t % 2) * 2 * BWD_BQ;
    const float* delta_t = lse_t + BWD_BQ;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t is in; both warpgroups are done with t - 1
    if (t + 1 < n_tiles) {
      load_q_tile(t + 1);
      cp_async_commit();
    }

    // S^T = K Q^T and dP^T = V dO^T: [64 keys, 64 rows] over D
    float s[32];
    float dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t kv_off = (ks / 4) * PANEL_KV + wg * 64 * 128 +
                              (ks % 4) * 32;
      const uint32_t q_off = (ks / 4) * PANEL_Q + (ks % 4) * 32;
      mma_ss_n64<0, 0>(s, sw128_desc(k_s + kv_off, 16, 1024),
                       sw128_desc(qs + q_off, 16, 1024), ks > 0);
      mma_ss_n64<0, 0>(dp, sw128_desc(v_s + kv_off, 16, 1024),
                       sw128_desc(dos + q_off, 16, 1024), ks > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(s);
    pin(dp);

    // p and dS per (key, row) pair; only tiles the diagonal crosses mask
    const bool diag = causal && wk0 + 63 > q0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = acc_col(i, lane);
      const int qi = q0 + qc;
      const int kj = wk0 + krow[acc_half(i)];
      pair_grad<float>(s[i], dp[i], lse_t[qc], delta_t[qc],
                       diag && kj > qi, qi < Sq && kj < Sk, scale,
                       scale_log2e, s[i], dp[i]);
    }
    uint32_t pa[4][4];
    uint32_t dsa[4][4];
    pack_a<64>(s, pa);
    pack_a<64>(dp, dsa);

    // dS^T to shared memory for the dQ product: row = key, queries
    // contiguous, one swizzled panel of 128 rows
    if constexpr (DQ) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 64 * wg + krow[r % 2];
          const int col = 16 * kk + 8 * (r / 2) + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(ds_ptr +
                                       tile_offset<BWD_BK>(row, col)) =
              dsa[kk][r];
        }
      }
      fence_async_smem();
    }

    // dV += P~^T dO and dK += dS^T Q: k16 slices over the 64 rows
    pin(dv_acc);
    pin(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs<D, 1>(dv_acc, pa[kk], sw128_desc(dos + kk * 2048, PANEL_Q, 1024),
                   1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs<D, 1>(dk_acc, dsa[kk], sw128_desc(qs + kk * 2048, PANEL_Q, 1024),
                   1);
    }
    wg_commit();
    if constexpr (DQ) __syncthreads();  // both warpgroups' dS^T is stored

    // K3's dQ = dS K over the block's 128 keys, [64 rows, 64 columns]:
    // the warpgroup's half of D (the first warpgroup alone at D = 64)
    if (DQ && (D == 128 || wg == 0)) {
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      const uint32_t k_cols = k_s + (D == 128 ? wg * PANEL_KV : 0);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < BWD_BK / 16; ++ks) {
        mma_ss_n64<1, 1>(dq, sw128_desc(ds_s + ks * 2048, PANEL_KV, 1024),
                         sw128_desc(k_cols + ks * 2048, PANEL_KV, 1024),
                         ks > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(dq);
      float* slot = dq_partial +
          (static_cast<size_t>(blockIdx.y) * gridDim.x + bh) * Sq * D +
          (D == 128 ? 64 * wg : 0);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int qi = q0 + 16 * warp + lane / 4 + 8 * hf;
        if (qi >= Sq) continue;
        float* out = slot + static_cast<size_t>(qi) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i0 = 4 * j + 2 * hf;
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(dq[i0], dq[i0 + 1]);
        }
      }
    } else {
      wg_wait_all();
    }
    pin(dv_acc);
    pin(dk_acc);
    pin(pa);
    pin(dsa);
  }

  bf16* dkb = dk + k_head;
  bf16* dvb = dv + k_head;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kj = wk0 + krow[hf];
    if (kj >= Sk) continue;
    const size_t at = static_cast<size_t>(kj) * stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i0 = 4 * j + 2 * hf;
      *reinterpret_cast<uint32_t*>(dkb + at + 8 * j) =
          pack_bf16(dk_acc[i0], dk_acc[i0 + 1]);
      *reinterpret_cast<uint32_t*>(dvb + at + 8 * j) =
          pack_bf16(dv_acc[i0], dv_acc[i0 + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_NT, 1)
bwd_fused_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, float* __restrict__ dq_partial,
                    int H, int Sq, int Sk, int causal, float scale,
                    float scale_log2e) {
  bwd_kv_walk<D, true>(q, k, v, dO, lse2, delta, dk, dv, dq_partial, H, Sq,
                       Sk, causal, scale, scale_log2e);
}

template <int D>
__global__ void __launch_bounds__(BWD_NT, 1)
bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dO,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int Sq, int Sk, int causal,
                   float scale, float scale_log2e) {
  bwd_kv_walk<D, false>(q, k, v, dO, lse2, delta, dk, dv, nullptr, H, Sq,
                        Sk, causal, scale, scale_log2e);
}

// Pass 2: dq[b, qi, h, :] = the sum, in slot order, of the slots that
// wrote row qi -- under causal masking the 128-key blocks starting at or
// before the row's 64-row tile, t <= qi / 128 -- stored in bf16.
template <int D>
__global__ void __launch_bounds__(RED_NT)
dq_reduce_tc_kernel(const float* __restrict__ partial, bf16* __restrict__ dq,
                    int BH, int H, int Sq, int slots, int causal) {
  constexpr int V4 = D / 4;
  const size_t idx = static_cast<size_t>(blockIdx.x) * RED_NT + threadIdx.x;
  if (idx >= static_cast<size_t>(BH) * Sq * V4) return;
  const int c = static_cast<int>(idx % V4) * 4;
  const size_t row = idx / V4;                // bh * Sq + qi
  const int qi = static_cast<int>(row % Sq);
  const int bh = static_cast<int>(row / Sq);
  const int last = causal ? min(slots - 1, qi / BWD_BK) : slots - 1;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t slot_floats = static_cast<size_t>(BH) * Sq * D;
  const float* src = partial + row * D + c;
  for (int t = 0; t <= last; ++t) {
    const float4 x = *reinterpret_cast<const float4*>(src + t * slot_floats);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const int b = bh / H;
  const int h = bh % H;
  bf16* out = dq + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D + c;
  uint2 packed;
  packed.x = pack_bf16(sum.x, sum.y);
  packed.y = pack_bf16(sum.z, sum.w);
  *reinterpret_cast<uint2*>(out) = packed;
}

// Both passes on `stream`; `partial` holds bwd_slots(Sk) slots of
// [B*H, Sq, D] f32.
template <int D>
cudaError_t launch_bwd_fused_tc(const void* q, const void* k, const void* v,
                                const void* dO, const float* lse2,
                                const float* delta, void* dq, void* dk,
                                void* dv, float* partial, int B, int H,
                                int Sq, int Sk, int causal, float scale,
                                float scale_log2e, cudaStream_t stream) {
  const int slots = bwd_slots(Sk);
  constexpr int smem = bwd_smem_bytes<D, true>();
  auto kernel = bwd_fused_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, slots), BWD_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse2, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), partial, H, Sq, Sk,
      causal, scale, scale_log2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * Sq * (D / 4);
  dq_reduce_tc_kernel<D><<<static_cast<unsigned>((n + RED_NT - 1) / RED_NT),
                           RED_NT, 0, stream>>>(
      partial, static_cast<bf16*>(dq), B * H, H, Sq, slots, causal);
  return cudaGetLastError();
}

// K2b on `stream`: one block per (batch-head, 128-key block).
template <int D>
cudaError_t launch_bwd_dkdv_tc(const void* q, const void* k, const void* v,
                               const void* dO, const float* lse2,
                               const float* delta, void* dk, void* dv, int B,
                               int H, int Sq, int Sk, int causal, float scale,
                               float scale_log2e, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D, false>();
  auto kernel = bwd_dkdv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, bwd_slots(Sk)), BWD_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), lse2, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, causal,
      scale, scale_log2e);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace dtf
