// K1, float32 route -- the flash attention forward on Hopper's tensor
// cores with the f32-accurate split product (tf32x3.cuh).
//
// Replaces, for float32 inputs, the TPU kernel
// dtf_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_pallas_forward`).  The function is blockwise.py block_accumulate's:
// scores in f32, the additive NEG_INF bias on masked keys (only on
// tiles the causal diagonal or the ragged key end crosses), the running
// max clamped to NEG_INF before exp, the denominator summed from the
// unrounded P, o and lse = max(m, NEG_INF) + log(l or 1) in f32.  The
// exponentials are taken in base 2, exp(x) = exp2(x log2 e), with the
// scores and the running max carried times log2 e, as on the bf16 route.
//
// What bounds it on the card: operations.  At the training shape
// [8, 2048, 6, 128], causal, the two tile products are 5.2e10 flop of
// f32-accurate work -- 0.31 ms at 165 TFLOP/s (495 TFLOP/s of TF32 over
// the three products of the split), 0.77 ms at the CUDA cores' 67.  So
// both products are split TF32 mma.sync: S = Q K^T with Q and K
// fragments read from shared memory, O += P V with P read back from
// this warp's rows of a P tile (relabelled, see tf32x3.cuh) and V from
// shared memory.  mma.sync takes its operands from registers, so what
// the design saves is the work around each product: every operand
// value a lane loads is split (four instructions) before the tensor
// core sees it.  A warp therefore owns 32 query rows -- two m16 tiles
// that share every K and V fragment it splits -- and reads fragments
// 8 or 16 bytes at a time.  Sums: S is a fresh chain every 16 values
// of D, O every 16 keys, each folded into its f32 sum (O with the
// softmax rescale as one fma); see tf32x3.cuh for why.
//
// Design.  A block of four warps owns 128 query rows of one batch-head
// (resident in shared memory) and walks 32-key tiles, with one K and
// one V slot: the copy of K(t + 1) runs while P V(t) is multiplied, the
// copy of V(t + 1) while S(t + 1) is, so each wait is half a tile
// behind its copy.  Registers are what limit the design -- a lane holds
// 128 O accumulators at D 128 -- so P waits in shared memory between
// the products, as do each row's running max and denominator between
// tiles, and the P V loop steps over pairs of k8 slices without
// unrolling them.  113 KB of shared memory at D 128: two blocks fill an
// SM's 228 KB.  A warp skips the causal tiles past
// its last row; the mask is applied only on tiles the diagonal or the
// key end crosses; the blocks of the last query tiles, the longest
// under causal masking, start first.
//
// Layout: q, k, v, o [B, S, H, D] contiguous f32, D 64 or 128; lse
// [B*H, Sq] f32.  Grid (B*H, ceil(Sq / 128)).  Rows past a sequence are
// zero-filled in shared memory, keys past Sk get the NEG_INF bias, rows
// past Sq are not stored.
#pragma once

#include "attn_tile.cuh"
#include "tf32x3.cuh"

namespace dtf {
namespace x3 {

constexpr int FWD_BQ = 128;  // query rows per block, 32 per warp
constexpr int FWD_BK = 32;   // keys per K/V tile
constexpr int FWD_NT = 128;
constexpr float FWD_LOG2E = 1.4426950408889634f;
constexpr float FWD_LN2 = 0.6931471805599453f;

template <int D>
constexpr int fwd_smem_bytes() {
  // the Q tile, one K and one V tile, P [128 rows][32 keys], the
  // running max and denominator of each row
  return ((FWD_BQ + 2 * FWD_BK) * D + FWD_BQ * FWD_BK + 2 * FWD_BQ) * 4;
}

template <int D>
__global__ void __launch_bounds__(FWD_NT, 2)
flash_fwd_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int H, int Sq, int Sk,
                    int causal, float scale) {
  constexpr int NT = D / 8;  // n8 tiles of O
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + FWD_BQ * D;
  float* v_s = k_s + FWD_BK * D;
  float* p_s = v_s + FWD_BK * D;
  // m of block row r at m_s[r], l at m_s[FWD_BQ + r]: touched once a tile,
  // so they wait here rather than in registers
  float* m_s = p_s + FWD_BQ * FWD_BK;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_BQ;
  const float scale_log2e = scale * FWD_LOG2E;
  const size_t stride = static_cast<size_t>(H) * D;
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * H + h) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * H + h) * D;

  // causal: keys past the block's last query are dead for every row
  const int q_last = min(q0 + FWD_BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int n_tiles = (k_end + FWD_BK - 1) / FWD_BK;

  load_rows<FWD_BQ, D, FWD_NT>(q_s, qb, stride, q0, Sq, tid);
  load_rows<FWD_BK, D, FWD_NT>(k_s, kb, stride, 0, Sk, tid);
  cp_async_commit();
  load_rows<FWD_BK, D, FWD_NT, true>(v_s, vb, stride, 0, Sk, tid);
  cp_async_commit();

  // this warp's 32 rows; row slot rs = 2 mi + hf of this thread is row
  // wq0 + 16 mi + 8 hf + g
  const int wr0 = 32 * warp;
  const int wq0 = q0 + wr0;
  const int wq_last = min(wq0 + 31, Sq - 1);
  // Fragment offsets (tf32x3.cuh): every row a lane reads is g, or 2 t4
  // and 2 t4 + 1, modulo 8, so its chunk permutation is a lane constant
  // and each fragment address is a lane base plus a compile-time offset.
  // Q rows wr0 + 16 mi + 8 h + g and K rows 8 n + g, chunk 4 kk + t4:
  // (4 kk + t4) ^ sw = 4 (kk ^ sb) + ((t4 ^ sw) & 3)
  const int sw = swz<D, false>(g);
  const int sb = sw >> 2;
  const int q_lane = (wr0 + g) * D + 4 * ((t4 ^ sw) & 3);
  const int k_lane = g * D + 4 * ((t4 ^ sw) & 3);
  // V rows 8 j + 2 t4 (+ 1), column pair 16 pp + 2 g: chunk
  // 4 pp + g / 2, permuted by 2 t4 -- 4 (pp ^ t4 / 2) + ((g / 2 ^ 2 t4) & 3)
  const int v_lane = 2 * t4 * D + 4 * (((g >> 1) ^ (2 * t4)) & 3) + 2 * (g & 1);
  const int v_even = v_lane + 16 * (t4 >> 1);
  const int v_odd = v_lane - 16 * (t4 >> 1);
  float o_acc[2][NT][4];
  zero(o_acc);
  // block row of this thread's row slot rs
  auto slot_row = [&](int rs) {
    return wr0 + 16 * (rs / 2) + 8 * (rs % 2) + g;
  };
#pragma unroll
  for (int rs = 0; rs < 4; ++rs) {
    m_s[slot_row(rs)] = NEG_INF;
    m_s[FWD_BQ + slot_row(rs)] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FWD_BK;
    cp_async_wait<1>();
    __syncthreads();  // K(t) is in (V(t) may still be in flight)
    // warp-uniform: some row of this warp sees a key of the tile
    const bool live = wq0 < Sq && !(causal && k0 > wq_last);
    float s[2][FWD_BK / 8][4];
    float corr[4];
    if (live) {
      // S = Q K^T, [32 rows, 32 keys], over D in pairs of k8 slices,
      // each pair a fresh chain folded into S
      zero(s);
#pragma unroll 1
      for (int kk = 0; kk < D / 16; ++kk) {
        const int kx = 16 * (kk ^ sb);
        FragA a[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* qr = q_s + q_lane + kx + 16 * mi * D;
          split_a(a[mi], *reinterpret_cast<const float4*>(qr),
                  *reinterpret_cast<const float4*>(qr + 8 * D));
        }
#pragma unroll
        for (int n = 0; n < FWD_BK / 8; ++n) {
          FragB bk[2];
          split_b(bk, *reinterpret_cast<const float4*>(k_s + k_lane + kx +
                                                       8 * n * D));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            float t[4];
            mma3_z(t, a[mi][0], bk[0]);
            mma3(t, a[mi][1], bk[1]);
            fold(s[mi][n], t);
          }
        }
      }

      // online softmax over the tile in base 2; a row's four lanes
      // share a quad.  s[mi][n][i] is row slot 2 mi + i / 2, key
      // k0 + 8 n + 2 t4 + i % 2
      const bool mask =
          k0 + FWD_BK > Sk || (causal && k0 + FWD_BK - 1 > wq0);
      float mt[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int n = 0; n < FWD_BK / 8; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rs = 2 * mi + i / 2;
            float x = s[mi][n][i] * scale_log2e;
            if (mask) {
              const int kp = k0 + 8 * n + 2 * t4 + i % 2;
              const int qr = wq0 + 16 * mi + 8 * (i / 2) + g;
              if (kp >= Sk || (causal && kp > qr)) x += NEG_INF;
            }
            s[mi][n][i] = x;
            mt[rs] = fmaxf(mt[rs], x);
          }
        }
      }
      // a row's four lanes all read its m and l before any writes them
      float m_old[4];
      float l_old[4];
#pragma unroll
      for (int rs = 0; rs < 4; ++rs) {
        m_old[rs] = m_s[slot_row(rs)];
        l_old[rs] = m_s[FWD_BQ + slot_row(rs)];
      }
      __syncwarp();
      float m_safe[4];
#pragma unroll
      for (int rs = 0; rs < 4; ++rs) {
        mt[rs] = fmaxf(mt[rs], __shfl_xor_sync(0xffffffffu, mt[rs], 1));
        mt[rs] = fmaxf(mt[rs], __shfl_xor_sync(0xffffffffu, mt[rs], 2));
        const float m_new = fmaxf(m_old[rs], mt[rs]);
        m_safe[rs] = fmaxf(m_new, NEG_INF);
        corr[rs] = exp2f(m_old[rs] - m_safe[rs]);
        m_s[slot_row(rs)] = m_new;
      }
      float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int n = 0; n < FWD_BK / 8; ++n) {
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
      store_pairs(p_s, s[0], wr0 + g, t4);
      store_pairs(p_s, s[1], wr0 + 16 + g, t4);
#pragma unroll
      for (int rs = 0; rs < 4; ++rs) {
        ls[rs] += __shfl_xor_sync(0xffffffffu, ls[rs], 1);
        ls[rs] += __shfl_xor_sync(0xffffffffu, ls[rs], 2);
        m_s[FWD_BQ + slot_row(rs)] = l_old[rs] * corr[rs] + ls[rs];
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // V(t) is in; every warp is done with K(t)
    if (t + 1 < n_tiles) {
      load_rows<FWD_BK, D, FWD_NT>(k_s, kb, stride, k0 + FWD_BK, Sk,
                                   thread_x());
      cp_async_commit();
    }
    if (live) {
      // O = O corr + P V in two halves of the tile, each a fresh chain
      // of two k8 slices folded into O (the first with the rescale):
      // slice j is keys 8 j .. 8 j + 7, and lane g's B values of the n8
      // tiles 2 pp and 2 pp + 1 are the column pair 16 pp + 2 g of V
#pragma unroll 1
      for (int jp = 0; jp < 2; ++jp) {
        FragA pa[2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          split_pairs(pa[jj][0], p_s, wr0 + g, 2 * jp + jj, t4);
          split_pairs(pa[jj][1], p_s, wr0 + 16 + g, 2 * jp + jj, t4);
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
          // n8 tile 2 pp + e: a fresh chain over the two slices, folded
          // into O with the rescale (corr is 1 after the first pair)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float t[2][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              FragB bv;
              bv.set(0, e ? v0[jj].y : v0[jj].x);
              bv.set(1, e ? v1[jj].y : v1[jj].x);
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                if (jj == 0) {
                  mma3_z(t[mi], pa[0][mi], bv);
                } else {
                  mma3(t[mi], pa[1][mi], bv);
                }
              }
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float& acc = o_acc[mi][2 * pp + e][i];
                acc = fmaf(acc, corr[2 * mi + i / 2], t[mi][i]);
              }
            }
          }
        }
#pragma unroll
        for (int rs = 0; rs < 4; ++rs) corr[rs] = 1.f;
      }
    }
    __syncthreads();  // every warp is done with V(t)
    if (t + 1 < n_tiles) {
      load_rows<FWD_BK, D, FWD_NT, true>(v_s, vb, stride, k0 + FWD_BK, Sk,
                                         thread_x());
      cp_async_commit();
    }
  }

  if (wq0 >= Sq) return;
  const int bh_out = block_x();
  float* ob = o + (static_cast<size_t>(bh_out / H) * Sq * H + bh_out % H) * D;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rs = 2 * mi + hf;
      const int qi = wq0 + 16 * mi + 8 * hf + g;
      if (qi >= Sq) continue;
      const float l = m_s[FWD_BQ + slot_row(rs)];
      const float denom = l == 0.f ? 1.f : l;
      // o = acc / l as acc times the correctly rounded 1 / l: within an
      // ulp of the quotient, and no division's slow path per element
      const float inv = __frcp_rn(denom);
      float* orow = ob + static_cast<size_t>(qi) * stride;
      // accumulator column 2 t4 + e of n8 tiles 2 pp and 2 pp + 1 is the
      // column pair 16 pp + 2 (2 t4 + e)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * hf + e;
#pragma unroll
        for (int pp = 0; pp < NT / 2; ++pp) {
          *reinterpret_cast<float2*>(orow + 16 * pp + 2 * (2 * t4 + e)) =
              make_float2(o_acc[mi][2 * pp][i] * inv,
                          o_acc[mi][2 * pp + 1][i] * inv);
        }
      }
      if (t4 == 0) {
        // back to natural log; a row no key reached keeps NEG_INF
        const float m = m_s[slot_row(rs)];
        const float m_nat = m > NEG_INF ? m * FWD_LN2 : NEG_INF;
        lse[static_cast<size_t>(bh_out) * Sq + qi] = m_nat + logf(denom);
      }
    }
  }
}

template <int D>
cudaError_t launch_fwd_x3(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int Sq, int Sk,
                          int causal, float scale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + FWD_BQ - 1) / FWD_BQ);
  kernel<<<grid, FWD_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Sq, Sk,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace x3
}  // namespace dtf
