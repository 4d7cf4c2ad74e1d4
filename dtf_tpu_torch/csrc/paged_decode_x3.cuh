// K4, chunk route in float32 -- the split pass of the paged flash decode
// on Hopper's tensor cores with the f32-accurate split product
// (tf32x3.cuh), for chunks of S >= 16 queries.
//
// K1's f32 tile walk (flash_fwd_x3.cuh) with a paged row address: a
// block of four warps owns 64 query rows of one (batch row, head), 16
// rows (one m16 tile) a warp, and one split of the row's keys, walked in
// 32-key tiles with one K and one V slot (the copy of K(t + 1) runs
// while P V(t) is multiplied, that of V(t + 1) while S(t + 1) is).  K1
// gives a warp two m16 tiles that share each K and V fragment it
// splits; at 64 rows that leaves two warps to hide the walk's latency,
// and one tile a warp ran the chunks faster on the card (X3_MI is the
// knob).  Each key row is looked up through the block table
// (paged_split.cuh key_offset), so any page size works.  Products,
// chains and folds are K1 f32's: S a fresh chain every 16 values of D,
// O every 16 keys, each folded into its f32 sum (O with the softmax
// rescale as one fma), so the route stays inside the 1e-5 gate of the
// exact plain version.  The mask is positional (query i at index[b] + i
// admits key p iff p <= index[b] + i; keys at or past the split's end
// are masked too).  The pass writes the un-normalized f32 o, m and l of
// each row to the partials; the combine (paged_split.cuh) normalizes.
#pragma once

#include "paged_split.cuh"
#include "tf32x3.cuh"

namespace dtf {
namespace paged {

constexpr int X3_BQ = 64;  // query rows per block
constexpr int X3_MI = 1;   // m16 row tiles per warp: 16 rows, four warps
constexpr int X3_BK = 32;  // keys per K/V tile
constexpr int X3_NT = 32 * X3_BQ / (16 * X3_MI);

template <int D>
constexpr int split_x3_smem_bytes() {
  // the Q tile, one K and one V tile, P [rows][32 keys], the running max
  // and denominator of each row
  return ((X3_BQ + 2 * X3_BK) * D + X3_BQ * X3_BK + 2 * X3_BQ) * 4;
}

// Issue the copies of keys [k0, k0 + X3_BK) of head h into the swizzled
// tile dst[X3_BK][D] (x3::chunk_at's layout, PAIRS for V); keys at or
// past `hi` are zero-filled.
template <int D, bool PAIRS>
__device__ __forceinline__ void load_keys_x3(float* dst, const float* pool,
                                             const int* tbl, int k0, int hi,
                                             int page, int P, int H, int h,
                                             int tid) {
  constexpr int CPR = D / 4;        // 16-byte chunks per row
  constexpr int RPI = X3_NT / CPR;  // rows per step
  static_assert(X3_NT % CPR == 0 && X3_BK % RPI == 0, "copies split evenly");
  const int c = tid % CPR;
#pragma unroll
  for (int it = 0; it < X3_BK / RPI; ++it) {
    const int r = tid / CPR + it * RPI;
    const bool valid = k0 + r < hi;
    const float* src =
        pool + (valid ? key_offset(tbl, k0 + r, page, P, H, h, D) : 0) + 4 * c;
    x3::cp_async16(x3::smem_u32(dst + x3::chunk_at<D, PAIRS>(r, c)), src,
                   valid);
  }
}

// Grid (n_split, ceil(S / X3_BQ), B * H).
template <int D>
__global__ void __launch_bounds__(X3_NT)
paged_split_x3_kernel(const float* __restrict__ q,
                      const float* __restrict__ pool_k,
                      const float* __restrict__ pool_v,
                      const int* __restrict__ table,
                      const int* __restrict__ index,
                      float* __restrict__ o_part,
                      float* __restrict__ ml_part, int S, int H, int P,
                      int page, int M, int kps, float scale_log2e) {
  using namespace x3;
  constexpr int NT = D / 8;  // n8 tiles of O
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + X3_BQ * D;
  float* v_s = k_s + X3_BK * D;
  float* p_s = v_s + X3_BK * D;
  // m of block row r at m_s[r], l at m_s[X3_BQ + r]
  float* m_s = p_s + X3_BQ * X3_BK;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int sp = blockIdx.x;
  const int q0 = blockIdx.y * X3_BQ;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh % H;
  const int rows = min(X3_BQ, S - q0);
  const int start = index[b];
  const KeyRange kr = split_keys(sp, kps, start, q0, rows, M * page);
  const size_t prow = part_row(bh, sp, gridDim.x, S, q0);
  if (kr.lo >= kr.hi) {
    mark_empty(ml_part, prow, rows, tid, X3_NT);
    return;
  }
  const int* tbl = table + static_cast<size_t>(b) * M;
  const int n_tiles = (kr.hi - kr.lo + X3_BK - 1) / X3_BK;

  load_rows<X3_BQ, D, X3_NT>(
      q_s, q + (static_cast<size_t>(b) * S * H + h) * D,
      static_cast<size_t>(H) * D, q0, S, tid);
  load_keys_x3<D, false>(k_s, pool_k, tbl, kr.lo, kr.hi, page, P, H, h, tid);
  cp_async_commit();
  load_keys_x3<D, true>(v_s, pool_v, tbl, kr.lo, kr.hi, page, P, H, h, tid);
  cp_async_commit();

  // this warp's 16 MI rows; row slot rs = 2 mi + hf of this thread is
  // block row wr0 + 16 mi + 8 hf + g, at position start + q0 + that row
  constexpr int RS = 2 * X3_MI;  // row slots a thread
  const int wr0 = 16 * X3_MI * warp;
  const int wpos0 = start + q0 + wr0;
  const int wpos_last = start + q0 + min(wr0 + 16 * X3_MI - 1, rows - 1);
  // fragment offsets: flash_fwd_x3.cuh's
  const int sw = swz<D, false>(g);
  const int sb = sw >> 2;
  const int q_lane = (wr0 + g) * D + 4 * ((t4 ^ sw) & 3);
  const int k_lane = g * D + 4 * ((t4 ^ sw) & 3);
  const int v_lane = 2 * t4 * D + 4 * (((g >> 1) ^ (2 * t4)) & 3) + 2 * (g & 1);
  const int v_even = v_lane + 16 * (t4 >> 1);
  const int v_odd = v_lane - 16 * (t4 >> 1);
  float o_acc[X3_MI][NT][4];
  zero(o_acc);
  auto slot_row = [&](int rs) {
    return wr0 + 16 * (rs / 2) + 8 * (rs % 2) + g;
  };
#pragma unroll
  for (int rs = 0; rs < RS; ++rs) {
    m_s[slot_row(rs)] = NEG_INF;
    m_s[X3_BQ + slot_row(rs)] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kr.lo + t * X3_BK;
    cp_async_wait<1>();
    __syncthreads();  // K(t) is in (V(t) may still be in flight)
    // warp-uniform: some row of this warp is below S and sees a key of
    // the tile
    const bool live = wr0 < rows && k0 <= wpos_last;
    float s[X3_MI][X3_BK / 8][4];
    float corr[RS];
    if (live) {
      // S = Q K^T, [16 MI rows, 32 keys], over D in pairs of k8 slices,
      // each pair a fresh chain folded into S
      zero(s);
#pragma unroll 1
      for (int kk = 0; kk < D / 16; ++kk) {
        const int kx = 16 * (kk ^ sb);
        FragA a[X3_MI][2];
#pragma unroll
        for (int mi = 0; mi < X3_MI; ++mi) {
          const float* qr = q_s + q_lane + kx + 16 * mi * D;
          split_a(a[mi], *reinterpret_cast<const float4*>(qr),
                  *reinterpret_cast<const float4*>(qr + 8 * D));
        }
#pragma unroll
        for (int n = 0; n < X3_BK / 8; ++n) {
          FragB bk[2];
          split_b(bk, *reinterpret_cast<const float4*>(k_s + k_lane + kx +
                                                       8 * n * D));
#pragma unroll
          for (int mi = 0; mi < X3_MI; ++mi) {
            float tt[4];
            mma3_z(tt, a[mi][0], bk[0]);
            mma3(tt, a[mi][1], bk[1]);
            fold(s[mi][n], tt);
          }
        }
      }

      // online softmax over the tile in base 2; s[mi][n][i] is row slot
      // 2 mi + i / 2, key k0 + 8 n + 2 t4 + i % 2
      const bool mask = k0 + X3_BK > kr.hi || k0 + X3_BK - 1 > wpos0;
      float mt[RS];
#pragma unroll
      for (int rs = 0; rs < RS; ++rs) mt[rs] = NEG_INF;
#pragma unroll
      for (int mi = 0; mi < X3_MI; ++mi) {
#pragma unroll
        for (int n = 0; n < X3_BK / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rs = 2 * mi + i / 2;
            float x = s[mi][n][i] * scale_log2e;
            if (mask) {
              const int kp = k0 + 8 * n + 2 * t4 + i % 2;
              const int qp = wpos0 + 16 * mi + 8 * (i / 2) + g;
              if (kp >= kr.hi || kp > qp) x += NEG_INF;
            }
            s[mi][n][i] = x;
            mt[rs] = fmaxf(mt[rs], x);
          }
        }
      }
      // a row's four lanes all read its m and l before any writes them
      float m_old[RS];
      float l_old[RS];
#pragma unroll
      for (int rs = 0; rs < RS; ++rs) {
        m_old[rs] = m_s[slot_row(rs)];
        l_old[rs] = m_s[X3_BQ + slot_row(rs)];
      }
      __syncwarp();
      float m_safe[RS];
#pragma unroll
      for (int rs = 0; rs < RS; ++rs) {
        mt[rs] = fmaxf(mt[rs], __shfl_xor_sync(0xffffffffu, mt[rs], 1));
        mt[rs] = fmaxf(mt[rs], __shfl_xor_sync(0xffffffffu, mt[rs], 2));
        const float m_new = fmaxf(m_old[rs], mt[rs]);
        m_safe[rs] = fmaxf(m_new, NEG_INF);
        corr[rs] = exp2f(m_old[rs] - m_safe[rs]);
        m_s[slot_row(rs)] = m_new;
      }
      float ls[RS];
#pragma unroll
      for (int rs = 0; rs < RS; ++rs) ls[rs] = 0.f;
#pragma unroll
      for (int mi = 0; mi < X3_MI; ++mi) {
#pragma unroll
        for (int n = 0; n < X3_BK / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rs = 2 * mi + i / 2;
            const float p = exp2f(s[mi][n][i] - m_safe[rs]);
            ls[rs] += p;
            s[mi][n][i] = p;
          }
        }
      }
      // P to this warp's rows of the P tile, read back as A fragments
#pragma unroll
      for (int mi = 0; mi < X3_MI; ++mi) {
        store_pairs(p_s, s[mi], wr0 + 16 * mi + g, t4);
      }
#pragma unroll
      for (int rs = 0; rs < RS; ++rs) {
        ls[rs] += __shfl_xor_sync(0xffffffffu, ls[rs], 1);
        ls[rs] += __shfl_xor_sync(0xffffffffu, ls[rs], 2);
        m_s[X3_BQ + slot_row(rs)] = l_old[rs] * corr[rs] + ls[rs];
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // V(t) is in; every warp is done with K(t)
    if (t + 1 < n_tiles) {
      load_keys_x3<D, false>(k_s, pool_k, tbl, k0 + X3_BK, kr.hi, page, P,
                             H, h, tid);
      cp_async_commit();
    }
    if (live) {
      // O = O corr + P V in two halves of the tile, each a fresh chain
      // of two k8 slices folded into O (the first with the rescale)
#pragma unroll 1
      for (int jp = 0; jp < 2; ++jp) {
        FragA pa[2][X3_MI];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int mi = 0; mi < X3_MI; ++mi) {
            split_pairs(pa[jj][mi], p_s, wr0 + 16 * mi + g, 2 * jp + jj,
                        t4);
          }
        }
        const float* vj = v_s + 16 * jp * D;
#pragma unroll
        for (int pp = 0; pp < NT / 2; ++pp) {
          float2 v0[2];
          float2 v1[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float* vr =
                vj + (pp % 2 ? v_odd : v_even) + 16 * pp + 8 * jj * D;
            v0[jj] = *reinterpret_cast<const float2*>(vr);
            v1[jj] = *reinterpret_cast<const float2*>(vr + D);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float tt[X3_MI][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              FragB bv;
              bv.set(0, e ? v0[jj].y : v0[jj].x);
              bv.set(1, e ? v1[jj].y : v1[jj].x);
#pragma unroll
              for (int mi = 0; mi < X3_MI; ++mi) {
                if (jj == 0) {
                  mma3_z(tt[mi], pa[0][mi], bv);
                } else {
                  mma3(tt[mi], pa[1][mi], bv);
                }
              }
            }
#pragma unroll
            for (int mi = 0; mi < X3_MI; ++mi) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float& acc = o_acc[mi][2 * pp + e][i];
                acc = fmaf(acc, corr[2 * mi + i / 2], tt[mi][i]);
              }
            }
          }
        }
#pragma unroll
        for (int rs = 0; rs < RS; ++rs) corr[rs] = 1.f;
      }
    }
    __syncthreads();  // every warp is done with V(t)
    if (t + 1 < n_tiles) {
      load_keys_x3<D, true>(v_s, pool_v, tbl, k0 + X3_BK, kr.hi, page, P, H,
                            h, tid);
      cp_async_commit();
    }
  }

  // the un-normalized partial of each row below S
  if (wr0 >= rows) return;
#pragma unroll
  for (int mi = 0; mi < X3_MI; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rs = 2 * mi + hf;
      const int qi = wr0 + 16 * mi + 8 * hf + g;
      if (qi >= rows) continue;
      const size_t r = prow + qi;
      float* dst = o_part + r * D;
      // accumulator column 2 t4 + e of n8 tiles 2 pp and 2 pp + 1 is the
      // column pair 16 pp + 2 (2 t4 + e)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * hf + e;
#pragma unroll
        for (int pp = 0; pp < NT / 2; ++pp) {
          *reinterpret_cast<float2*>(dst + 16 * pp + 2 * (2 * t4 + e)) =
              make_float2(o_acc[mi][2 * pp][i], o_acc[mi][2 * pp + 1][i]);
        }
      }
      if (t4 == 0) {
        ml_part[2 * r] = m_s[slot_row(rs)];
        ml_part[2 * r + 1] = m_s[X3_BQ + slot_row(rs)];
      }
    }
  }
}

template <int D>
cudaError_t launch_split_x3(const void* q, const void* pk, const void* pv,
                            const int* table, const int* index,
                            float* o_part, float* ml_part, int B, int S,
                            int H, int P, int page, int M, int kps,
                            int n_split, float scale_log2e,
                            cudaStream_t stream) {
  constexpr int smem = split_x3_smem_bytes<D>();
  auto kernel = paged_split_x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (S + X3_BQ - 1) / X3_BQ, B * H);
  kernel<<<grid, X3_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pk),
      static_cast<const float*>(pv), table, index, o_part, ml_part, S, H, P,
      page, M, kps, scale_log2e);
  return cudaGetLastError();
}

}  // namespace paged
}  // namespace dtf
