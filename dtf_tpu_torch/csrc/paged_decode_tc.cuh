// K4, chunk route in bf16 -- the split pass of the paged flash decode on
// Hopper's tensor cores, for chunks of S >= 16 queries (continuation
// prefill chunks).
//
// K1's bf16 tile walk (flash_fwd_tc.cuh) with a paged row address: a
// block of one warpgroup owns 64 query rows of one (batch row, head) and
// one split of the row's keys, and walks the split in 64-key K/V tiles
// through a two-stage cp.async ring in 128-byte-swizzled shared memory.
// Each key row of a tile is looked up through the block table
// (paged_split.cuh key_offset): at page 16 a tile is four pages, each a
// run of 16 rows at stride H * D; any page size works, and pages need
// not divide the tile.  S = Q K^T and O += P V are wgmma (m64n64k16 from
// shared memory; m64nDk16 with P from registers and V read MN-major), P
// rounded to bf16 before P V, the denominator summed from the unrounded
// P.  The mask is positional: query i sits at index[b] + i and admits
// key p iff p <= index[b] + i; keys at or past the split's end get the
// NEG_INF bias too.  The pass writes the un-normalized f32 o, m and l of
// each row to the partials; the combine (paged_split.cuh) normalizes.
#pragma once

#include "hopper.cuh"
#include "paged_split.cuh"

namespace dtf {
namespace paged {

constexpr int TC_BQ = 64;   // query rows per block: one warpgroup
constexpr int TC_BK = 64;   // keys per K/V tile
constexpr int TC_NT = 128;

template <int D>
constexpr int split_tc_smem_bytes() {
  // the Q tile, two stages of K and V tiles, and slack to align to 1024
  return TC_BQ * D * 2 + 2 * 2 * TC_BK * D * 2 + 1024;
}

// Issue the copies of keys [k0, k0 + TC_BK) of head h into the swizzled
// K and V tiles at k_dst and v_dst; keys at or past `hi` are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv_tc(uint32_t k_dst, uint32_t v_dst,
                                           const tc::bf16* pool_k,
                                           const tc::bf16* pool_v,
                                           const int* tbl, int k0, int hi,
                                           int page, int P, int H, int h,
                                           int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < TC_BK * CPR / TC_NT; ++it) {
    const int idx = tid + it * TC_NT;
    const int r = idx / CPR;
    const int c = idx % CPR;
    const bool valid = k0 + r < hi;
    const size_t off =
        (valid ? key_offset(tbl, k0 + r, page, P, H, h, D) : 0) + c * 8;
    const uint32_t at = tc::tile_offset<TC_BK>(r, c * 8);
    tc::cp_async16(k_dst + at, pool_k + off, valid);
    tc::cp_async16(v_dst + at, pool_v + off, valid);
  }
}

// Grid (n_split, ceil(S / 64), B * H).
template <int D>
__global__ void __launch_bounds__(TC_NT)
paged_split_tc_kernel(const tc::bf16* __restrict__ q,
                      const tc::bf16* __restrict__ pool_k,
                      const tc::bf16* __restrict__ pool_v,
                      const int* __restrict__ table,
                      const int* __restrict__ index,
                      float* __restrict__ o_part,
                      float* __restrict__ ml_part, int S, int H, int P,
                      int page, int M, int kps, float scale_log2e) {
  using namespace tc;
  constexpr int Q_BYTES = TC_BQ * D * 2;
  constexpr int KV_BYTES = TC_BK * D * 2;
  constexpr int PANEL_Q = TC_BQ * 128;  // bytes of a 64-column panel
  constexpr int PANEL_KV = TC_BK * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  // stage s of the ring: K at kv_s + 2 s KV_BYTES, V right after it
  const uint32_t kv_s = q_s + Q_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sp = blockIdx.x;
  const int q0 = blockIdx.y * TC_BQ;
  const int bh = blockIdx.z;
  const int n_split = gridDim.x;
  const int b = bh / H;
  const int h = bh % H;
  const int rows = min(TC_BQ, S - q0);
  const int start = index[b];
  const KeyRange kr = split_keys(sp, kps, start, q0, rows, M * page);
  const size_t prow = part_row(bh, sp, n_split, S, q0);
  if (kr.lo >= kr.hi) {
    mark_empty(ml_part, prow, rows, tid, TC_NT);
    return;
  }
  const int* tbl = table + static_cast<size_t>(b) * M;
  const int n_tiles = (kr.hi - kr.lo + TC_BK - 1) / TC_BK;

  load_rows<TC_BQ, D, TC_NT>(
      q_s, q + (static_cast<size_t>(b) * S * H + h) * D,
      static_cast<size_t>(H) * D, q0, S, tid);
  load_kv_tc<D>(kv_s, kv_s + KV_BYTES, pool_k, pool_v, tbl, kr.lo, kr.hi,
                page, P, H, h, tid);
  cp_async_commit();

  // this thread's two rows of the block, and their positions
  int qrow[2];
  qrow[0] = 16 * warp + lane / 4;
  qrow[1] = qrow[0] + 8;
  const int qpos0 = start + q0;
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
    __syncthreads();  // tile t is in; the warpgroup is done with t - 1
    if (t + 1 < n_tiles) {
      const uint32_t next = kv_s + ((t + 1) % 2) * 2 * KV_BYTES;
      load_kv_tc<D>(next, next + KV_BYTES, pool_k, pool_v, tbl,
                    kr.lo + (t + 1) * TC_BK, kr.hi, page, P, H, h, tid);
      cp_async_commit();
    }
    const int k0 = kr.lo + t * TC_BK;

    // S = Q K^T, [64 rows, 64 keys], over D in k16 steps
    float s[TC_BK / 2];
#pragma unroll
    for (int i = 0; i < TC_BK / 2; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t along = (ks % 4) * 32;  // 16 columns into the panel
      mma_ss_n64<0, 0>(
          s, sw128_desc(q_s + (ks / 4) * PANEL_Q + along, 16, 1024),
          sw128_desc(k_s + (ks / 4) * PANEL_KV + along, 16, 1024), ks > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(s);

    // online softmax over the tile in base 2; a row's four lanes share
    // a quad.  Masked: keys past the split's end, or past a row's
    // position -- only on tiles that reach either
    const bool mask = k0 + TC_BK > kr.hi || k0 + TC_BK - 1 > qpos0;
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < TC_BK / 2; ++i) {
      const int hf = acc_half(i);
      float x = s[i] * scale_log2e;
      if (mask) {
        const int kp = k0 + acc_col(i, lane);
        if (kp >= kr.hi || kp > qpos0 + qrow[hf]) x += NEG_INF;
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
    for (int i = 0; i < TC_BK / 2; ++i) {
      const int hf = acc_half(i);
      const float p = exp2f(s[i] - m_safe[hf]);
      ls[hf] += p;
      s[i] = p;
    }
    uint32_t pa[TC_BK / 16][4];
    pack_a<TC_BK>(s, pa);
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
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      mma_rs<D, 1>(o_acc, pa[kk],
                   sw128_desc(v_s + kk * 16 * 128, PANEL_KV, 1024), 1);
    }
    wg_commit();
    wg_wait_all();
    pin(o_acc);
    pin(pa);
  }

  // the un-normalized partial of each row below S
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (qrow[hf] >= rows) continue;
    const size_t r = prow + qrow[hf];
    float* dst = o_part + r * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i0 = 4 * j + 2 * hf;
      *reinterpret_cast<float2*>(dst + 8 * j + 2 * (lane % 4)) =
          make_float2(o_acc[i0], o_acc[i0 + 1]);
    }
    if (lane % 4 == 0) {
      ml_part[2 * r] = m[hf];
      ml_part[2 * r + 1] = l[hf];
    }
  }
}

template <int D>
cudaError_t launch_split_tc(const void* q, const void* pk, const void* pv,
                            const int* table, const int* index,
                            float* o_part, float* ml_part, int B, int S,
                            int H, int P, int page, int M, int kps,
                            int n_split, float scale_log2e,
                            cudaStream_t stream) {
  constexpr int smem = split_tc_smem_bytes<D>();
  auto kernel = paged_split_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (S + TC_BQ - 1) / TC_BQ, B * H);
  kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(pk),
      static_cast<const tc::bf16*>(pv), table, index, o_part, ml_part, S, H,
      P, page, M, kps, scale_log2e);
  return cudaGetLastError();
}

}  // namespace paged
}  // namespace dtf
