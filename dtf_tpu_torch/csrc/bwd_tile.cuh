// Tile math shared by the three flash-backward kernels: K2a (dq, in
// flash_bwd.cu), K2b (dk and dv, flash_bwd.cu) and K3 (dq, dk and dv
// from one walk, flash_bwd_fused.cu).
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
// nothing.  Products run on CUDA cores in f32 (products of bf16 values
// are exact in f32), as in the forward kernel.
//
// Tiles are BT x BT with BT = 32 queries and 32 keys; a block has NT =
// 128 threads, TPR = 4 consecutive lanes per query row (or per key in
// the key-major kernels), so a row's lanes share a warp.  Every output
// element has one writer: no atomics, the same bits on every run.
#pragma once

#include "attn_tile.cuh"

namespace dtf {

constexpr int BT = 32;          // queries and keys per tile
constexpr int TPR = NT / BT;    // lanes per query row or key

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

// Shared-memory floats of the key-major kernels: K, V, Q and dO tiles
// [BT][D + 1], P~ and dS [BT keys][BT + 1 rows], lse2 and delta [BT].
template <int D>
constexpr int kv_smem_floats() {
  return 4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT;
}

// One block per (key tile, batch-head): K2b, and with DQ_PARTIAL the
// fused K3.  The block's BT keys stay in shared memory while it walks
// the live query tiles (under causal masking, those whose rows reach
// the block's first key); dk and dv accumulate in registers, lane `sub`
// of key j owning columns sub + c * TPR.
//
// With DQ_PARTIAL, each query tile's dq contribution from this block's
// keys, dS[:, block] K[block], is written to the block's own f32 slot
// dq_partial[blockIdx.x][bh][q][:] -- the TPU kernel's whole-sequence
// VMEM dq scratch has no counterpart in 227 KB of shared memory, and one
// writer per slot keeps the sum (flash_bwd_fused.cu dq_reduce) free of
// atomics and the same on every run.
//
// Layout: q, k, v, dO, dk, dv [B, S, H, D]; lse2, delta [B*H, Sq] f32.
template <typename T, int D, bool DQ_PARTIAL>
__global__ void __launch_bounds__(NT)
kv_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ lse2,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dq_partial, int H,
                int Sq, int Sk, int causal, float scale, float scale_log2e) {
  constexpr int LD = D + 1;
  constexpr int LDP = BT + 1;
  constexpr int RPT = BT / TPR;   // query rows per lane
  constexpr int CPT = D / TPR;    // output columns per lane
  constexpr int CG = 16;          // dq columns summed per pass
  static_assert(CPT % CG == 0, "dq columns split into passes of 16");
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BT * LD;
  float* q_s = v_s + BT * LD;
  float* do_s = q_s + BT * LD;
  float* p_s = do_s + BT * LD;
  float* ds_s = p_s + BT * LDP;
  float* lse_s = ds_s + BT * LDP;
  float* delta_s = lse_s + BT;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BT;
  const int j = threadIdx.x / TPR;   // this lane's key in the tile
  const int sub = threadIdx.x % TPR;
  const int kj = k0 + j;
  const bool key_live = kj < Sk;

  auto row = [&](const T* base, int S, int s) -> const T* {
    return s < S ? base + ((static_cast<size_t>(b) * S + s) * H + h) * D
                 : nullptr;
  };
  load_tile<T, D, BT>(k_s, [&](int i) { return row(k, Sk, k0 + i); });
  load_tile<T, D, BT>(v_s, [&](int i) { return row(v, Sk, k0 + i); });

  float dk_acc[CPT];
  float dv_acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  // causal: query tiles that end before the block's first key are dead
  // (tiles of queries and keys have one size, so the first live tile
  // starts at k0)
  for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += BT) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<T, D, BT>(q_s, [&](int i) { return row(q, Sq, q0 + i); });
    load_tile<T, D, BT>(do_s, [&](int i) { return row(dO, Sq, q0 + i); });
    if (threadIdx.x < BT) {
      const int qi = q0 + threadIdx.x;
      const size_t at = static_cast<size_t>(bh) * Sq + qi;
      lse_s[threadIdx.x] = qi < Sq ? lse2[at] : 0.f;
      delta_s[threadIdx.x] = qi < Sq ? delta[at] : 0.f;
    }
    __syncthreads();
    // only tiles the diagonal crosses pay for the mask
    const bool straddles = causal && (k0 + BT - 1 > q0);

    float s[RPT];
    float dp[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[i] = dp[i] = 0.f;
    const float* kr = k_s + j * LD;
    const float* vr = v_s + j * LD;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
      const float vd = vr[d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        s[i] = fmaf(kd, q_s[(sub + i * TPR) * LD + d], s[i]);
        dp[i] = fmaf(vd, do_s[(sub + i * TPR) * LD + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = sub + i * TPR;
      const int qi = q0 + r;
      float p, ds;
      pair_grad<T>(s[i], dp[i], lse_s[r], delta_s[r], straddles && kj > qi,
                   key_live && qi < Sq, scale, scale_log2e, p, ds);
      p_s[j * LDP + r] = round_as<T>(p);
      ds_s[j * LDP + r] = ds;
    }
    __syncthreads();  // the dq pass reads every key's dS

    for (int r = 0; r < BT; ++r) {
      const float pj = p_s[j * LDP + r];
      const float dsj = ds_s[j * LDP + r];
      const float* dor = do_s + r * LD + sub;
      const float* qr = q_s + r * LD + sub;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dv_acc[c] = fmaf(pj, dor[c * TPR], dv_acc[c]);
        dk_acc[c] = fmaf(dsj, qr[c * TPR], dk_acc[c]);
      }
    }

    if constexpr (DQ_PARTIAL) {
      // row-major now: lane (row r, sub) sums dS[r, :] K over the keys
      const int r = threadIdx.x / TPR;
      const int qi = q0 + r;
      if (qi < Sq) {
        float* out = dq_partial +
            ((static_cast<size_t>(blockIdx.x) * gridDim.y + bh) * Sq + qi) *
                D + sub;
        for (int c0 = 0; c0 < CPT; c0 += CG) {
          float acc[CG];
#pragma unroll
          for (int c = 0; c < CG; ++c) acc[c] = 0.f;
          for (int jj = 0; jj < BT; ++jj) {
            const float dsr = ds_s[jj * LDP + r];
            const float* kk = k_s + jj * LD + sub;
#pragma unroll
            for (int c = 0; c < CG; ++c) {
              acc[c] = fmaf(dsr, kk[(c0 + c) * TPR], acc[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < CG; ++c) out[(c0 + c) * TPR] = acc[c];
        }
      }
    }
  }

  if (key_live) {
    T* dkr = dk + ((static_cast<size_t>(b) * Sk + kj) * H + h) * D + sub;
    T* dvr = dv + ((static_cast<size_t>(b) * Sk + kj) * H + h) * D + sub;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store<T>(dkr + c * TPR, dk_acc[c]);
      store<T>(dvr + c * TPR, dv_acc[c]);
    }
  }
}

// Launch kv_block_kernel on grid (ceil(Sk / BT), B*H).
template <typename T, int D, bool DQ_PARTIAL>
cudaError_t launch_kv_blocks(const void* q, const void* k, const void* v,
                             const void* dO, const float* lse2,
                             const float* delta, void* dk, void* dv,
                             float* dq_partial, int B, int H, int Sq, int Sk,
                             int causal, float scale, float scale_log2e,
                             cudaStream_t stream) {
  const int smem = kv_smem_floats<D>() * sizeof(float);
  auto kernel = kv_block_kernel<T, D, DQ_PARTIAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BT - 1) / BT, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse2, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), dq_partial, H, Sq, Sk,
      causal, scale, scale_log2e);
  return cudaGetLastError();
}

}  // namespace dtf
