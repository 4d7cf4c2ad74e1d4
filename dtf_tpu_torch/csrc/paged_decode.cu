// K4 -- paged flash decode for Hopper (sm_90a).
//
// Replaces the TPU kernel dtf_tpu/ops/paged_attention.py
// `_paged_decode_kernel` (launched by `paged_flash_decode`): the S
// queries of each batch row attend over that row's KV history, read from
// the shared page pool THROUGH the row's block table inside the kernel,
// so no gathered window ever exists in device memory.  Query i of row b
// sits at position index[b] + i and admits key p iff p <= index[b] + i
// (write-then-attend: the chunk's own K/V are already in the pool).
// Keys past the last query of the tile are never read: the loop stops
// at the live length, the dead-page skip of the TPU kernel.  The carry
// (o, m, l) is f32 across tiles, the same rule as the flash kernels.
//
// What bounds it on the card: decode (S = 1) and continuation chunks
// (S = 64) do O(S * L * D) work over O(L * D) bytes of K/V, so it is
// bound by bytes -- the live K/V pages read once.  Scalar prefetch has
// no Hopper counterpart: each block reads index[b] and its own
// block-table row.  This first version loads one 64-key tile of K and
// V into shared memory per step (whole 16-byte vectors, page rows
// contiguous in the pool) and does the products on CUDA cores.  At
// decode it runs one block per (row, head) -- 48 blocks for 8 rows x 6
// heads, most of the 132 SMs idle, one latency-bound walk per block;
// splitting the pages of a row over blocks with a second combine pass
// is the first fix, left for later work.
//
// Layout: q, o [B, S, H, D]; pool_k, pool_v [P, page, H, D]; table
// [B, M] int32 page ids; index [B] int32.  Grid (ceil(S / BQ), B*H).
// Rows whose table is all zeros read the scratch page 0; the engine
// ignores their output.  Page ids are clamped into [0, P), as the
// gather they replace clamps out-of-range indices.
#include "attn_tile.cuh"

namespace {

using namespace dtf;

constexpr int BK = 64;  // keys per tile (any page size; looked up per key)

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int* __restrict__ table,
                    const int* __restrict__ index, T* __restrict__ o, int S,
                    int H, int P, int page, int M, float scale) {
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
  const int* tbl = table + static_cast<size_t>(b) * M;
  const int start = index[b];

  load_tile<T, D, BQ>(q_s, [&](int i) -> const T* {
    const int s = q0 + i;
    return s < S ? q + ((static_cast<size_t>(b) * S + s) * H + h) * D
                 : nullptr;
  });

  const int live_rows = min(BQ, S - q0);
  // keys this tile can see: up to its last query, within the table
  const int k_end = min(start + q0 + live_rows, M * page);
  const bool live = warp_has_live_row<BQ>(live_rows);

  auto pool_row = [&](const T* pool, int p) -> const T* {
    if (p >= k_end) return nullptr;
    const int pid = min(max(tbl[p / page], 0), P - 1);
    return pool + ((static_cast<size_t>(pid) * page + p % page) * H + h) * D;
  };

  Carry<D, BQ> carry;
  carry.init();
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D, BK>(k_s, [&](int i) { return pool_row(pool_k, k0 + i); });
    load_tile<T, D, BK>(v_s, [&](int i) { return pool_row(pool_v, k0 + i); });
    __syncthreads();
    if (live) {
      accumulate_tile<T, D, BQ, BK>(carry, q_s, k_s, v_s, p_s, r, sub, k0,
                                    k_end, start + q0 + r, true, scale);
    }
  }

  const int qi = q0 + r;
  if (qi < S) {
    const float denom = carry.l == 0.f ? 1.f : carry.l;
    T* orow = o + ((static_cast<size_t>(b) * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store<T>(orow + sub + c * TPR, carry.o[c] / denom);
    }
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* table, const int* index, void* o, int B,
                   int S, int H, int P, int page, int M, float scale,
                   cudaStream_t stream) {
  const int smem = smem_floats<D, BQ, BK>() * sizeof(float);
  auto kernel = paged_decode_kernel<T, D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, index, static_cast<T*>(o), S, H, P,
      page, M, scale);
  return cudaGetLastError();
}

// A decode step (S <= 4) gets 4 rows per block, one warp each, so the
// dead rows of the tile skip their math warp by warp; chunks get 16.
template <typename T, int D>
cudaError_t dispatch_rows(const void* q, const void* pk, const void* pv,
                          const int* table, const int* index, void* o, int B,
                          int S, int H, int P, int page, int M, float scale,
                          cudaStream_t stream) {
  if (S <= 4) {
    return launch<T, D, 4>(q, pk, pv, table, index, o, B, S, H, P, page, M,
                           scale, stream);
  }
  return launch<T, D, 16>(q, pk, pv, table, index, o, B, S, H, P, page, M,
                          scale, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* pk, const void* pv,
                       const int* table, const int* index, void* o, int B,
                       int S, int H, int D, int P, int page, int M,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return dispatch_rows<T, 64>(q, pk, pv, table, index, o, B, S, H, P,
                                  page, M, scale, stream);
    case 128:
      return dispatch_rows<T, 128>(q, pk, pv, table, index, o, B, S, H, P,
                                   page, M, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int dtf_paged_decode(const void* q, const void* pool_k,
                                const void* pool_v, const int* table,
                                const int* index, void* o, int B, int S,
                                int H, int D, int P, int page, int M,
                                int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(q, pool_k, pool_v, table, index, o, B, S, H, D,
                             P, page, M, scale, s);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(q, pool_k, pool_v, table, index, o, B,
                                     S, H, D, P, page, M, scale, s);
  }
  return cudaErrorInvalidValue;
}
