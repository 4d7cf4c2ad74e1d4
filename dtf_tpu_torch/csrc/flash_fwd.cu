// K1 -- flash attention forward for Hopper (sm_90a).
//
// Two routes, by dtype, neither falling back to the other: bfloat16 runs
// the tensor-core kernel of flash_fwd_tc.cuh (wgmma, cp.async ring);
// float32 runs `flash_fwd_kernel` below, on CUDA cores, whose f32
// products are exact (TF32 tensor cores would keep three digits, and
// f32 serving is held token-exact).  The rest of this note is the f32
// route's.
//
// Replaces the TPU kernel dtf_tpu/ops/flash_attention.py `_fwd_kernel`
// (launched by `_pallas_forward`): causal or full softmax(Q K^T scale) V
// with the online-softmax carry (o, m, l) kept in f32 on chip, dead
// causal tiles skipped, the mask applied only to tiles the diagonal
// crosses, and o (input dtype) plus lse = max(m, NEG_INF) + log(l or 1)
// (natural log, f32) written out.
//
// What bounds it on the card: at the serving shapes (S <= 2048, D = 128)
// attention is O(S^2 D) work over O(S D) bytes, so it is bound by
// operations -- here the f32 FMA rate of the CUDA cores.  The design
// keeps the O(S^2) score matrix out of device memory, which is what the
// TPU kernel was for.
//
// Layout: q, k, v, o are [B, S, H, D] contiguous; lse is [B*H, Sq].
// Grid (ceil(Sq / BQ), B*H): one block per (q tile, batch-head); a loop
// inside the block over K/V tiles takes the place of the TPU's
// sequential grid dimension.  Every output element has one writer.
// Ragged Sq/Sk are masked in the kernel, not rejected.
#include "attn_tile.cuh"
#include "flash_fwd_tc.cuh"

namespace {

using namespace dtf;

constexpr int BQ = 64;  // query rows per block (TPR = 2 lanes per row)
constexpr int BK = 32;  // keys per tile

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                 float scale) {
  constexpr int TPR = NT / BQ;
  constexpr int CPT = D / TPR;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * (D + 1);
  float* v_s = k_s + BK * (D + 1);
  float* p_s = v_s + BK * (D + 1);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;

  auto row = [&](const T* base, int S, int s) -> const T* {
    return s < S ? base + ((static_cast<size_t>(b) * S + s) * H + h) * D
                 : nullptr;
  };
  load_tile<T, D, BQ>(q_s, [&](int i) { return row(q, Sq, q0 + i); });

  const int live_rows = min(BQ, Sq - q0);
  const int q_last = q0 + live_rows - 1;
  // causal: keys past the tile's last query are dead for every row
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const bool live = warp_has_live_row<BQ>(live_rows);

  Carry<D, BQ> carry;
  carry.init();
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D, BK>(k_s, [&](int i) { return row(k, Sk, k0 + i); });
    load_tile<T, D, BK>(v_s, [&](int i) { return row(v, Sk, k0 + i); });
    __syncthreads();
    // only tiles the diagonal crosses pay for the mask
    const bool straddles = causal && (k0 + BK - 1 > q0);
    if (live) {
      accumulate_tile<T, D, BQ, BK>(carry, q_s, k_s, v_s, p_s, r, sub, k0,
                                    Sk, q0 + r, straddles, scale);
    }
  }

  const int qi = q0 + r;
  if (qi < Sq) {
    const float denom = carry.l == 0.f ? 1.f : carry.l;
    T* orow = o + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store<T>(orow + sub + c * TPR, carry.o[c] / denom);
    }
    if (sub == 0) {
      lse[static_cast<size_t>(bh) * Sq + qi] =
          fmaxf(carry.m, NEG_INF) + logf(denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Sk, int causal,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats<D, BQ, BK>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Sq, int Sk, int D,
                       int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int dtf_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int H, int Sq,
                             int Sk, int D, int dtype, int causal,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(q, k, v, o, lse, B, H, Sq, Sk, D, causal, scale,
                             s);
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
