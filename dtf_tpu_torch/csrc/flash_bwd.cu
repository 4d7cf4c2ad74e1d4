// K2a and K2b -- the split flash-attention backward for Hopper (sm_90a).
//
// Replace the TPU kernels dtf_tpu/ops/flash_attention.py `_dq_kernel`
// (K2a) and `_dkdv_kernel` (K2b), launched by
// `_pallas_backward(fused=False)`, with the numerics of `_bwd_tile`
// (see bwd_tile.cuh): probabilities recomputed per tile from the saved
// base-2 log-sum-exp, dead causal tiles skipped, the mask applied only
// on tiles the diagonal crosses, f32 sums, outputs in the inputs' dtype.
//
//   K2a: one block per (query tile, batch-head) walks the live key
//        tiles and keeps its rows' dq in registers, as the forward
//        kernel keeps o.
//   K2b: one block per (key tile, batch-head) walks the live query
//        tiles and keeps its keys' dk and dv (bwd_tile.cuh
//        kv_block_kernel).
// Every output tile has one writer, so no atomics and the same bits on
// every run.
//
// What bounds them on the card: at the training shape (S 2048, D 128)
// the backward is O(S^2 D) work over O(S D) bytes, so operations bound
// it -- here the f32 FMA rate of the CUDA cores, since this first
// version widens bf16 to f32 in shared memory and multiplies there, as
// K1 does.  The split pair recomputes S and dP in both kernels (7 tile
// products to K3's 5).  Tensor cores (wgmma) and TMA are later work.
//
// Layout: q, k, v, dO, dq, dk, dv [B, S, H, D] contiguous; lse2 (the
// forward's lse times log2 e) and delta = rowsum(dO * o) are [B*H, Sq]
// f32.  Ragged Sq and Sk are masked in the kernels.
#include "bwd_tile.cuh"

namespace {

using namespace dtf;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, int causal, float scale,
                    float scale_log2e) {
  constexpr int LD = D + 1;
  constexpr int LDS = BT + 1;
  constexpr int KPT = BT / TPR;   // keys per lane
  constexpr int CPT = D / TPR;    // dq columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BT * LD;
  float* k_s = do_s + BT * LD;
  float* v_s = k_s + BT * LD;
  float* ds_s = v_s + BT * LD;    // [BT rows][BT + 1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BT;
  const int r = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int qi = q0 + r;
  const bool row_live = qi < Sq;

  auto row = [&](const T* base, int S, int s) -> const T* {
    return s < S ? base + ((static_cast<size_t>(b) * S + s) * H + h) * D
                 : nullptr;
  };
  load_tile<T, D, BT>(q_s, [&](int i) { return row(q, Sq, q0 + i); });
  load_tile<T, D, BT>(do_s, [&](int i) { return row(dO, Sq, q0 + i); });
  const size_t at = static_cast<size_t>(bh) * Sq + qi;
  const float lse2_r = row_live ? lse2[at] : 0.f;
  const float delta_r = row_live ? delta[at] : 0.f;

  // causal: keys past the tile's last query are dead for every row
  const int q_last = min(Sq, q0 + BT) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
  const float* qr = q_s + r * LD;
  const float* dor = do_s + r * LD;
  float* dsr = ds_s + r * LDS;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous key tile is consumed
    load_tile<T, D, BT>(k_s, [&](int i) { return row(k, Sk, k0 + i); });
    load_tile<T, D, BT>(v_s, [&](int i) { return row(v, Sk, k0 + i); });
    __syncthreads();
    const bool straddles = causal && (k0 + BT - 1 > q0);

    float s[KPT];
    float dp[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
      const float dd = dor[d];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        s[i] = fmaf(qd, k_s[(sub + i * TPR) * LD + d], s[i]);
        dp[i] = fmaf(dd, v_s[(sub + i * TPR) * LD + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kp = k0 + sub + i * TPR;
      float p, ds;
      pair_grad<T>(s[i], dp[i], lse2_r, delta_r, straddles && kp > qi,
                   row_live && kp < Sk, scale, scale_log2e, p, ds);
      dsr[sub + i * TPR] = ds;
    }
    __syncwarp();  // a row's dS is written by its own lanes
    for (int jj = 0; jj < BT; ++jj) {
      const float d = dsr[jj];
      const float* kk = k_s + jj * LD + sub;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = fmaf(d, kk[c * TPR], acc[c]);
    }
  }

  if (row_live) {
    T* out = dq + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D + sub;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store<T>(out + c * TPR, acc[c]);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dO, const float* lse2, const float* delta,
                      void* dq, int B, int H, int Sq, int Sk, int causal,
                      float scale, float scale_log2e, cudaStream_t stream) {
  const int smem = (4 * BT * (D + 1) + BT * (BT + 1)) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BT - 1) / BT, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse2, delta,
      static_cast<T*>(dq), H, Sq, Sk, causal, scale, scale_log2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dO, const float* lse2,
                        const float* delta, void* dk, void* dv, int B, int H,
                        int Sq, int Sk, int causal, float scale,
                        float scale_log2e, cudaStream_t stream) {
  return launch_kv_blocks<T, D, false>(q, k, v, dO, lse2, delta, dk, dv,
                                       nullptr, B, H, Sq, Sk, causal, scale,
                                       scale_log2e, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128.  Each returns the
// launch's cudaError_t.
extern "C" int dtf_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dO, const float* lse2,
                                const float* delta, void* dq, int B, int H,
                                int Sq, int Sk, int D, int dtype, int causal,
                                float scale, float scale_log2e,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DTF_DQ(T, DD)                                                     \
  return launch_dq<T, DD>(q, k, v, dO, lse2, delta, dq, B, H, Sq, Sk,    \
                          causal, scale, scale_log2e, s)
  if (dtype == 0 && D == 64) DTF_DQ(float, 64);
  if (dtype == 0 && D == 128) DTF_DQ(float, 128);
  if (dtype == 1 && D == 64) DTF_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) DTF_DQ(__nv_bfloat16, 128);
#undef DTF_DQ
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
#define DTF_DKDV(T, DD)                                                    \
  return launch_dkdv<T, DD>(q, k, v, dO, lse2, delta, dk, dv, B, H, Sq,   \
                            Sk, causal, scale, scale_log2e, s)
  if (dtype == 0 && D == 64) DTF_DKDV(float, 64);
  if (dtype == 0 && D == 128) DTF_DKDV(float, 128);
  if (dtype == 1 && D == 64) DTF_DKDV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) DTF_DKDV(__nv_bfloat16, 128);
#undef DTF_DKDV
  return cudaErrorInvalidValue;
}
