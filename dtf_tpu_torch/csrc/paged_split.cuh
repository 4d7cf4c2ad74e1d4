// The split-KV pieces shared by K4's routes (paged_decode.cu): the key
// range of a split, where a key's head row lies in the page pool, where
// a split's partial result goes, and the combine pass that folds the
// partials of each query row in split order.
//
// Partials.  A split pass writes, for each (batch-head, split, query)
// row, the un-normalized f32 output o_s = sum_j p_j v_j over the split's
// keys, its running max m_s (scores carried times log2 e, the base-2
// exponentials of the flash kernels) and its denominator l_s = sum_j
// p_j, into scratch the wrapper allocates:
//   o_part  [B * H, n_split, S, D] f32,
//   ml_part [B * H, n_split, S, 2] f32 (m_s, l_s).
// Nothing is normalized or rounded to the output dtype before the
// combine, so nothing is rounded twice.
//
// The combine.  o = sum_s 2^(m_s - M) o_s / sum_s 2^(m_s - M) l_s with
// M = max_s m_s, the splits folded in a fixed order (four warps a query
// row, each a contiguous quarter of the splits, the quarters added in
// warp order): one writer per output row, no atomics, the same bits on
// every run.  A
// split past the row's live length writes m_s = NEG_INF, l_s = 0 and no
// o_s; the combine gives it weight 0 and never reads its o_s.  A
// query that sees none of a live split's keys carries m_s = NEG_INF
// there (every score biased by NEG_INF) and l_s > 0; its weight
// 2^(NEG_INF - M) is exactly 0, since split 0 always holds key 0, which
// every query sees, so M is a real score.
#pragma once

#include "attn_tile.cuh"

namespace dtf {
namespace paged {

// Keys [lo, hi) of split `sp` for the query rows [q0, q0 + rows) of a
// batch row at `start` = index[b]: those rows see keys up to
// start + q0 + rows - 1, within the table's `capacity` = M * page.
// Empty when lo >= hi.
struct KeyRange {
  int lo;
  int hi;
};

__device__ __forceinline__ KeyRange split_keys(int sp, int kps, int start,
                                               int q0, int rows,
                                               int capacity) {
  const int k_end = min(start + q0 + rows, capacity);
  const int lo = sp * kps;
  return {lo, min(lo + kps, k_end)};
}

// Element offset of key p's row for head h in a [P, page, H, D] pool,
// through the batch row's block-table row `tbl`; page ids clamped into
// [0, P), as the gather this replaces clamps out-of-range indices.
__device__ __forceinline__ size_t key_offset(const int* tbl, int p, int page,
                                             int P, int H, int h, int D) {
  const int pid = min(max(__ldg(tbl + p / page), 0), P - 1);
  return ((static_cast<size_t>(pid) * page + p % page) * H + h) * D;
}

// Row index of query qi of split sp in the partials.
__device__ __forceinline__ size_t part_row(int bh, int sp, int n_split, int S,
                                           int qi) {
  return (static_cast<size_t>(bh) * n_split + sp) * S + qi;
}

// An empty split's rows [row0, row0 + rows): m = NEG_INF, l = 0.
__device__ __forceinline__ void mark_empty(float* ml_part, size_t row0,
                                           int rows, int tid, int nt) {
  for (int i = tid; i < rows; i += nt) {
    ml_part[2 * (row0 + i)] = NEG_INF;
    ml_part[2 * (row0 + i) + 1] = 0.f;
  }
}

constexpr int COMBINE_NW = 4;     // warps folding one query row
constexpr int COMBINE_NT = 32 * COMBINE_NW;
constexpr int COMBINE_BATCH = 4;  // splits whose o_s a lane loads at once

// Grid (S, B * H); o [B, S, H, D].  One block a query row.  Every warp
// finds M = max_s m_s (lane j reading splits j, j + 32, ...) and the
// splits through the last one of nonzero weight, n_live -- all of them
// live: a dead split has l = 0 and only dead splits follow it, so every
// o_s read was written, and a live split whose keys the query cannot
// see has weight exactly 0.  Warp w folds the w-th quarter of [0,
// n_live) in order, lane i columns i + 32 c, loading the o_s of
// COMBINE_BATCH splits before their sums; the quarters' partial sums are
// then added in warp order.  So the fold pays one memory latency a
// batch of a quarter, not one a split, and its order is fixed.
template <typename T, int D>
__global__ void __launch_bounds__(COMBINE_NT)
paged_combine_kernel(const float* __restrict__ o_part,
                     const float* __restrict__ ml_part, T* __restrict__ o,
                     int S, int H, int n_split) {
  constexpr int CPL = D / 32;
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ float part[COMBINE_NW][D + 1];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  // split sp of this row: m at ml[sp * ml_step], l after it, o_s at
  // os + sp o_step
  const size_t row0 = part_row(bh, 0, n_split, S, qi);
  const float* ml = ml_part + 2 * row0;
  const float* os = o_part + row0 * D + lane;
  const size_t ml_step = 2 * static_cast<size_t>(S);
  const size_t o_step = static_cast<size_t>(S) * D;
  float mx = NEG_INF;
  for (int sp = lane; sp < n_split; sp += 32) {
    mx = fmaxf(mx, ml[sp * ml_step]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  }
  auto weight = [&](int sp) {
    const float ls = ml[sp * ml_step + 1];
    return ls > 0.f ? exp2f(ml[sp * ml_step] - mx) : 0.f;  // 0: empty
  };
  int n_live = 0;
  for (int s0 = 0; s0 < n_split; s0 += 32) {
    const int sp = s0 + lane;
    const unsigned nz = __ballot_sync(FULL, sp < n_split && weight(sp) > 0.f);
    if (nz) n_live = s0 + 32 - __clz(nz);
  }
  const int per = (n_live + COMBINE_NW - 1) / COMBINE_NW;
  const int lo = warp * per;
  const int hi = min(lo + per, n_live);
  float l = 0.f;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
  for (int j0 = lo; j0 < hi; j0 += COMBINE_BATCH) {
    float x[COMBINE_BATCH][CPL];
    float w[COMBINE_BATCH];
    float ls[COMBINE_BATCH];
#pragma unroll
    for (int u = 0; u < COMBINE_BATCH; ++u) {
      const int sp = j0 + u;
      const bool in = sp < hi;
      w[u] = in ? weight(sp) : 0.f;
      ls[u] = in ? ml[sp * ml_step + 1] : 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        x[u][c] = in ? os[sp * o_step + 32 * c] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < COMBINE_BATCH; ++u) {
      if (j0 + u < hi) {
        l += w[u] * ls[u];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] += w[u] * x[u][c];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) part[warp][lane + 32 * c] = acc[c];
  if (lane == 0) part[warp][D] = l;
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = part[0][lane + 32 * c];
  l = part[0][D];
#pragma unroll
  for (int w = 1; w < COMBINE_NW; ++w) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] += part[w][lane + 32 * c];
    l += part[w][D];
  }
  const float denom = l == 0.f ? 1.f : l;
  const int b = bh / H;
  const int h = bh % H;
  T* dst = o + ((static_cast<size_t>(b) * S + qi) * H + h) * D + lane;
#pragma unroll
  for (int c = 0; c < CPL; ++c) store<T>(dst + 32 * c, acc[c] / denom);
}

template <typename T, int D>
cudaError_t launch_combine(const float* o_part, const float* ml_part, void* o,
                           int B, int S, int H, int n_split,
                           cudaStream_t stream) {
  const dim3 grid(S, B * H);
  paged_combine_kernel<T, D><<<grid, COMBINE_NT, 0, stream>>>(
      o_part, ml_part, static_cast<T*>(o), S, H, n_split);
  return cudaGetLastError();
}

}  // namespace paged
}  // namespace dtf
