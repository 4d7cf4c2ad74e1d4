// K2a, float32 route -- the split flash backward's dq on Hopper's tensor
// cores with the f32-accurate split product (tf32x3.cuh).
//
// Replaces, for float32 inputs, the TPU kernel
// dtf_tpu/ops/flash_attention.py `_dq_kernel` (launched by
// `_pallas_backward(fused=False)`), with the numerics of `_bwd_tile`
// (bwd_tile.cuh pair_grad, as in K3 and K2b, flash_bwd_x3.cuh): p =
// exp2(q.k scale log2 e - lse log2 e), the mask as a replacement by
// NEG_INF, dS = p (dp - delta) scale, f32 sums.
//
// What bounds it on the card: operations.  Three tile products per live
// (query, key) pair -- S, dP and dQ -- are 7.7e10 flop of f32-accurate
// work at the training shape [8, 2048, 6, 128], causal: 0.47 ms at 165
// TFLOP/s (495 TFLOP/s of TF32 over the split's three products), 1.15
// ms at the CUDA cores' 67.  All three are split TF32 mma.sync, shaped
// like K1's (flash_fwd_x3.cuh):
//   S   = Q K^T     A = Q, B = K, both from shared memory, contracted
//                   over D;
//   dP  = dO V^T    likewise;
//   dQ += dS K      A = dS, read back relabelled from the tile the
//                   S accumulators were parked in (tf32x3.cuh pair_at),
//                   B = K read under the same relabelling, rows 2t and
//                   2t + 1 of each k8 slice; lane g's B values of n8
//                   tile n sit in D column g NT + n (NT tiles), so a
//                   lane reads them 16 bytes at a time, and the store
//                   undoes the map.
// The K tile serves two reads -- rows g for S, rows 2t and 2t + 1 for
// dQ -- and the one chunk permutation of tf32x3.cuh keeps both free of
// bank conflicts.  Sums: S and dP are fresh chains every 16 values of
// D, dQ every 16 keys, each folded into its f32 sum (tf32x3.cuh says
// why).
//
// Design.  Query-major, as K2a's bf16 route (flash_bwd_dq_tc.cuh): a
// block of eight warps owns 128 query rows of one batch-head, one m16
// tile of 16 rows a warp.  Q, dO and the rows' lse2 and delta stay in
// shared memory for the whole walk; 32-key K and V tiles flow through a
// two-stage cp.async ring, the copies of tile t + 1 running while tile
// t is multiplied.  A warp's dQ, [16, D] f32, stays in registers for
// the whole walk and is stored once: one writer per dq row, no slots,
// no reduce pass, no atomics, the same bits on every run.  S and dP run
// one after the other: S waits in the warp's rows of a shared tile
// while dP is computed, and dS takes its place there, as K1's P does
// (pair_grad needs both S and dP).  209 KB of shared memory at D 128,
// so one block an SM, and registers set the warps it can hold: with
// K1's 32 rows a warp (two m16 tiles sharing each K and V split) a lane
// holds 128 dQ accumulators at D 128 and the kernel hit the
// 255-register cap, spilled, and ran slower on the card than with 16
// rows a warp, which holds 64 and lets eight warps share the SM's work
// where 32 rows have four.  A warp skips the causal tiles past its
// last row; the per-element mask and the ragged ends are checked only
// on tiles the diagonal or a sequence end crosses.  Blocks start in
// order of blockIdx, x fastest: the last query tiles, the longest walks
// under causal masking, go first.
//
// Layout: q, k, v, dO, dq [B, S, H, D] contiguous f32, D 64 or 128;
// lse2 and delta [B*H, Sq] f32.  Grid (B*H, ceil(Sq / 128)).  Rows past
// a sequence are zero-filled in shared memory and rows past Sq are not
// stored.  Positions count from 0 for queries and keys alike, so under
// causal masking a row at or past Sk sees every key.
#pragma once

#include "bwd_tile.cuh"
#include "tf32x3.cuh"

namespace dtf {
namespace x3 {

constexpr int DQ_BQ = 128;  // query rows per block, 16 a warp
constexpr int DQ_BK = 32;   // keys per K/V tile
constexpr int DQ_NT = 256;  // eight warps

template <int D>
constexpr int dq_smem_bytes() {
  // the Q and dO tiles, two stages of K and V tiles, the S / dS tile
  // [128 rows][32 keys], each row's lse2 and delta
  return (2 * DQ_BQ * D + 2 * 2 * DQ_BK * D + DQ_BQ * DQ_BK + 2 * DQ_BQ) *
         4;
}

template <int D>
__global__ void __launch_bounds__(DQ_NT, 1)
bwd_dq_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dO,
                 const float* __restrict__ lse2,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int H, int Sq, int Sk, int causal, float scale,
                 float scale_log2e) {
  constexpr int NT = D / 8;         // n8 tiles of dQ
  constexpr int NC = NT / 4;        // chunks of a lane's B values in a row
  constexpr int KT = DQ_BK * D;     // floats of one K or V tile
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + DQ_BQ * D;
  // stage s of the ring: K at kv_s + 2 s KT, V right after it
  float* kv_s = do_s + DQ_BQ * D;
  float* ds_s = kv_s + 4 * KT;           // S, then dS: [128][32], pair_at
  float* lse_s = ds_s + DQ_BQ * DQ_BK;   // lse2 of block row r at lse_s[r]
  float* delta_s = lse_s + DQ_BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t q_head = (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;

  // causal: keys past the block's last query are dead for every row
  const int q_last = min(q0 + DQ_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + DQ_BK - 1) / DQ_BK;

  load_rows<DQ_BQ, D, DQ_NT>(q_s, q + q_head, stride, q0, Sq, tid);
  load_rows<DQ_BQ, D, DQ_NT>(do_s, dO + q_head, stride, q0, Sq, tid);
  {
    // one row's lse2 (threads 0..127) or delta (128..255) a thread
    static_assert(DQ_NT == 2 * DQ_BQ, "a thread per lse2 and delta row");
    const int r = tid % DQ_BQ;
    const bool valid = q0 + r < Sq;
    const float* src = (tid < DQ_BQ ? lse2 : delta) +
                       static_cast<size_t>(bh) * Sq + (valid ? q0 + r : 0);
    cp_async4(smem_u32(lse_s + tid), src, valid);
  }
  load_rows<DQ_BK, D, DQ_NT>(kv_s, kb, stride, 0, Sk, tid);
  load_rows<DQ_BK, D, DQ_NT>(kv_s + KT, vb, stride, 0, Sk, tid);
  cp_async_commit();

  // this warp's 16 rows: accumulator i is block row wr0 + 8 (i / 2) + g
  const int wr0 = 16 * warp;
  const int wq0 = q0 + wr0;
  const int wq_last = min(wq0 + 15, Sq - 1);
  // S and dP fragment offsets (tf32x3.cuh): Q and dO rows wr0 + g (+ 8),
  // K and V rows 8 n + g, chunk 4 kk + t4 -- every row g modulo 8, so
  // the chunk is 4 (kk ^ sb) + ((t4 ^ sw) & 3)
  const int sw = swz<D, false>(g);
  const int sb = sw >> 2;
  const int a_lane = (wr0 + g) * D + 4 * ((t4 ^ sw) & 3);
  const int b_lane = g * D + 4 * ((t4 ^ sw) & 3);
  float dq_acc[NT][4];
  zero(dq_acc);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * DQ_BK;
    const float* ks = kv_s + (t % 2) * 2 * KT;
    const float* vs = ks + KT;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with t - 1
    if (t + 1 < n_tiles) {
      float* next = kv_s + ((t + 1) % 2) * 2 * KT;
      load_rows<DQ_BK, D, DQ_NT>(next, kb, stride, k0 + DQ_BK, Sk,
                                 thread_x());
      load_rows<DQ_BK, D, DQ_NT>(next + KT, vb, stride, k0 + DQ_BK, Sk,
                                 thread_x());
      cp_async_commit();
    }
    // warp-uniform: no row of this warp sees a key of the tile
    if (wq0 >= Sq || (causal && k0 > wq_last)) continue;

    // S = Q K^T, then dP = dO V^T: [16 rows, 32 keys] over D, in pairs of
    // k8 slices, each pair a fresh chain folded into the sum
    float s[DQ_BK / 8][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const float* as = pass == 0 ? q_s : do_s;
      const float* bs = pass == 0 ? ks : vs;
      zero(s);
#pragma unroll 1
      for (int kk = 0; kk < D / 16; ++kk) {
        const int kx = 16 * (kk ^ sb);
        FragA a[2];
        split_a(a, *reinterpret_cast<const float4*>(as + a_lane + kx),
                *reinterpret_cast<const float4*>(as + a_lane + kx + 8 * D));
#pragma unroll
        for (int n = 0; n < DQ_BK / 8; ++n) {
          FragB bk[2];
          split_b(bk, *reinterpret_cast<const float4*>(bs + b_lane + kx +
                                                       8 * n * D));
          float c[4];
          mma3_z(c, a[0], bk[0]);
          mma3(c, a[1], bk[1]);
          fold(s[n], c);
        }
      }
      if (pass == 1) break;
      // S waits in this warp's rows of the tile while dP is computed
      store_pairs(ds_s, s, wr0 + g, t4);
    }

    // dS per (row, key) pair from the parked S and dP (now in s), back
    // into the same places; only tiles the diagonal or a ragged end
    // crosses pay for the per-element checks.  Accumulator i of n8 tile
    // n is key k0 + 8 n + 2 t4 + i % 2
    const bool diag = causal && k0 + DQ_BK - 1 > wq0;
    const bool edge = diag || k0 + DQ_BK > Sk || wq0 + 16 > Sq;
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n) {
      float2* at0 =
          reinterpret_cast<float2*>(ds_s + pair_at(wr0 + g, 4 * n + t4));
      float2* at8 =
          reinterpret_cast<float2*>(ds_s + pair_at(wr0 + g + 8, 4 * n + t4));
      const float2 s0 = *at0;
      const float2 s8 = *at8;
      const float qk[4] = {s0.x, s0.y, s8.x, s8.y};
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr0 + g + 8 * (i / 2);
        const int qi = q0 + r;
        const int kj = k0 + 8 * n + 2 * t4 + i % 2;
        float p;
        pair_grad<float>(qk[i], s[n][i], lse_s[r], delta_s[r],
                         diag && kj > qi, !edge || (qi < Sq && kj < Sk),
                         scale, scale_log2e, p, ds[i]);
      }
      *at0 = make_float2(ds[0], ds[1]);
      *at8 = make_float2(ds[2], ds[3]);
    }
    __syncwarp();  // this warp's rows of dS are stored

    // dQ += dS K in two halves of the tile, each a fresh chain of two k8
    // slices folded into dQ: slice j is keys 8 j .. 8 j + 7, A slot t4
    // key 2 t4 and slot t4 + 4 key 2 t4 + 1, in dS and K alike
#pragma unroll 1
    for (int jp = 0; jp < 2; ++jp) {
      FragA pa[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        split_pairs(pa[jj], ds_s, wr0 + g, 2 * jp + jj, t4);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float x0[2][4];
        float x1[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int r = 16 * jp + 8 * jj + 2 * t4;
          const float4 u0 = lds_chunk<D>(ks, r, NC * g + c);
          const float4 u1 = lds_chunk<D>(ks, r + 1, NC * g + c);
          x0[jj][0] = u0.x; x0[jj][1] = u0.y; x0[jj][2] = u0.z;
          x0[jj][3] = u0.w;
          x1[jj][0] = u1.x; x1[jj][1] = u1.y; x1[jj][2] = u1.z;
          x1[jj][3] = u1.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float c4[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            FragB bb;
            bb.set(0, x0[jj][e]);
            bb.set(1, x1[jj][e]);
            if (jj == 0) {
              mma3_z(c4, pa[0], bb);
            } else {
              mma3(c4, pa[1], bb);
            }
          }
          fold(dq_acc[4 * c + e], c4);
        }
      }
    }
  }

  if (wq0 >= Sq) return;
  const int bh_out = block_x();
  float* dqb =
      dq + (static_cast<size_t>(bh_out / H) * Sq * H + bh_out % H) * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = wq0 + 8 * hf + g;
    if (qi >= Sq) continue;
    float* row = dqb + static_cast<size_t>(qi) * stride;
    // accumulator column 2 t4 + e of tile n is D column (2 t4 + e) NT + n
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * hf + e;
      float* col = row + (2 * t4 + e) * NT;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        *reinterpret_cast<float4*>(col + 4 * c) = make_float4(
            dq_acc[4 * c][i], dq_acc[4 * c + 1][i], dq_acc[4 * c + 2][i],
            dq_acc[4 * c + 3][i]);
      }
    }
  }
}

template <int D>
cudaError_t launch_bwd_dq_x3(const void* q, const void* k, const void* v,
                             const void* dO, const float* lse2,
                             const float* delta, void* dq, int B, int H,
                             int Sq, int Sk, int causal, float scale,
                             float scale_log2e, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  auto kernel = bwd_dq_x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + DQ_BQ - 1) / DQ_BQ);
  kernel<<<grid, DQ_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse2,
      delta, static_cast<float*>(dq), H, Sq, Sk, causal, scale, scale_log2e);
  return cudaGetLastError();
}

}  // namespace x3
}  // namespace dtf
