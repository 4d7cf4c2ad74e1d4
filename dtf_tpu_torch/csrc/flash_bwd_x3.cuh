// K3 and K2b, float32 route -- the key-major flash backward walk on
// Hopper's tensor cores with the f32-accurate split product
// (tf32x3.cuh).
//
// One walk, two kernels, as on the bf16 route (flash_bwd_tc.cuh):
//   bwd_fused_x3_kernel (K3, with dq) replaces, for float32 inputs, the
//     TPU kernel dtf_tpu/ops/flash_attention.py `_dfused_kernel`
//     (launched by `_pallas_backward(fused=True)`): dq, dk and dv from
//     one walk of the tile space;
//   bwd_dkdv_x3_kernel (K2b, without dq) replaces `_dkdv_kernel`
//     (`_pallas_backward(fused=False)`): dk and dv only.
// Both are bwd_kv_walk_x3<D, DQ>, with the numerics of `_bwd_tile`
// (bwd_tile.cuh pair_grad): p = exp2(q.k scale log2 e - lse log2 e), the
// mask as a replacement by NEG_INF on tiles the diagonal crosses, dS =
// p (dp - delta) scale, f32 sums.
//
// What bounds them on the card: operations.  Five tile products per live
// (query, key) pair for K3 -- S, dP, dV, dK and dQ -- four for K2b, are
// 1.3e11 and 1.0e11 flop of f32-accurate work at the training shape
// [8, 2048, 6, 128], causal: 0.78 and 0.63 ms at 165 TFLOP/s (495
// TFLOP/s of TF32 over the split's three products), 1.92 and 1.54 ms at
// the CUDA cores' 67.  All are split TF32 mma.sync:
//   S^T  = K Q^T     A = K (the warp's 16 keys), B = Q, both from shared
//                    memory, contracted over D;
//   dP^T = V dO^T    likewise;
//   dV  += P^T dO    A = P^T, stored from the S^T accumulators to a
//                    P^T tile and read back relabelled (slot t the row
//                    2t, slot t + 4 the row 2t + 1), B = dO read under
//                    the same relabelling;
//   dK  += dS^T Q    likewise from the dS^T tile;
//   dQ   = dS K      (K3 only) A = dS read from the dS^T tile, B = K,
//                    over the block's 128 keys.
// Computing S and dP transposed -- keys as the rows of the product --
// gives dV's and dK's A operands the layout of the S^T and dP^T
// accumulators.  As in K1, what costs is the work around each mma.sync:
// every operand value a lane loads is split first, so fragments are
// read 8 or 16 bytes at a time (tf32x3.cuh).  Sums: S^T and dP^T are
// fresh chains every 16 values of D, dV and dK every 8 rows, dQ every
// 32 keys, each folded into its f32 sum (tf32x3.cuh says why).
//
// Design.  A block of eight warps owns 128 keys of one batch-head (16 a
// warp: its dK and dV, [16, D] f32, stay in registers for the whole
// walk) and walks the live 32-row query tiles; Q, dO and their lse2 /
// delta rows flow through a two-stage cp.async ring.  Registers limit
// the design -- 128 dK and dV accumulators a lane at D 128 -- so S^T
// and dP^T run one after the other, P^T and dS^T wait in shared memory
// rather than registers, and the dV and dK loops step over the k8
// slices without unrolling them.  Tiles are unpadded and swizzled
// (tf32x3.cuh); 226.5 KB of shared memory at D 128 for K3, 224.5 KB for
// K2b, one block an SM.  A warp whose keys all lie past the tile's last
// row (causal) or past Sk skips its products.  The blocks of the first
// key blocks, the longest walks under causal masking, start first; a
// block whose first key lies past every query under causal masking
// walks nothing and writes zeros.
//
// K3's dq: each query tile's dQ over the block's 128 keys ([32, D],
// split by columns over the eight warps) reads every warp's dS^T rows,
// so K3 stores dS^T with rows padded to 36 floats (read down its
// columns), a dead warp stores zeros there, and a block-wide barrier
// sits between the dK and dQ products.  The dQ goes to the block's own
// f32 slot of `dq_partial` [ceil(Sk / 128), B*H, Sq, D], and
// dq_reduce_x3_kernel sums the slots that were written in slot order.
// One writer per slot and a fixed order: no atomics, the same bits on
// every run.  At the training shape the slots hold 16 x 48 x 2048 x 128
// f32 = 0.81 GB, about half of it written and read under causal
// masking.  K2b has none of this: a warp's dK reads only its own 16
// keys' dS^T rows, so its dS^T tile is laid out as P^T's (pair_at), and
// no barrier, slot or reduce pass follows (K2a, flash_bwd_dq_x3.cuh,
// computes dq query-major).
//
// Layout: q, k, v, dO, dk, dv [B, S, H, D] f32, D 64 or 128; lse2 (lse
// times log2 e) and delta [B*H, Sq] f32.  Positions count from 0 for
// queries and keys alike; ragged Sq and Sk, and Sq != Sk, are masked
// here.
#pragma once

#include "bwd_tile.cuh"
#include "flash_bwd_tc.cuh"
#include "tf32x3.cuh"

namespace dtf {
namespace x3 {

constexpr int BWD_BK = tc::BWD_BK;  // keys per block (and per dq slot)
constexpr int BWD_BQ = 32;          // query rows per tile of the walk
constexpr int BWD_NT = 256;         // eight warps, 16 keys each
constexpr int DS_LD = BWD_BQ + 4;   // padded row of the dS^T tile
constexpr int RED_NT = 256;         // threads per block of the reduce

template <int D, bool DQ>
constexpr int bwd_smem_bytes() {
  // K and V tiles, two stages of Q and dO tiles, dS^T (K3: padded rows),
  // P^T, two stages of lse2 and delta rows
  return (2 * BWD_BK * D + 2 * 2 * BWD_BQ * D +
          BWD_BK * (DQ ? DS_LD : BWD_BQ) + BWD_BK * BWD_BQ +
          2 * 2 * BWD_BQ) * 4;
}

// dQ's output columns: a warp owns D / 4 of them, NPW = D / 32 n8
// tiles, and column j of tile n is column NPW dq_perm(j) + n of its
// quarter, so that lane g reads its NPW B values as one vector and the
// lanes g = 0, 1 of a quarter-warp land on chunks that differ in bit 2
// (D 128: one chunk each) or bit 1 (D 64: half a chunk each).
template <int D>
__device__ __forceinline__ int dq_perm(int j) {
  if constexpr (D == 128) {
    return ((j & 1) << 2) | (j >> 1);
  } else {
    return (j & 1) | ((j & 2) << 1) | ((j & 4) >> 1);
  }
}

// The walk of one 128-key block; DQ adds K3's dq product and slot write
// (`dq_partial` is unused without it).
template <int D, bool DQ>
__device__ __forceinline__ void bwd_kv_walk_x3(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dq_partial, int H, int Sq, int Sk, int causal,
    float scale, float scale_log2e) {
  constexpr int NT = D / 8;     // n8 tiles of dK and dV
  constexpr int NC = NT / 4;    // chunks of a lane's B values in a row
  constexpr int QT = BWD_BQ * D;  // floats of one Q or dO tile
  constexpr int NPW = D / 32;   // dQ n8 tiles a warp
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + BWD_BK * D;
  // stage s of the ring: Q at st_s + 2 s QT, dO right after it
  float* st_s = v_s + BWD_BK * D;
  // dS^T [128 keys][36] (K3) or [128 keys][32], pair_at (K2b)
  float* ds_s = st_s + 4 * QT;
  float* pt_s = ds_s + BWD_BK * (DQ ? DS_LD : BWD_BQ);  // P^T, pair_at
  // stage s: lse2 at rows + 2 s BQ, delta at rows + 2 s BQ + BQ
  float* rows = pt_s + BWD_BK * BWD_BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
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
  // k0 is a multiple of the 32-row tile, so the first live tile starts
  // at k0
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = q_begin < Sq ? (Sq - q_begin + BWD_BQ - 1) / BWD_BQ
                                   : 0;

  auto load_q_tile = [&](int t) {
    const int qt0 = q_begin + t * BWD_BQ;
    float* qs = st_s + (t % 2) * 2 * QT;
    load_rows<BWD_BQ, D, BWD_NT>(qs, q + q_head, stride, qt0, Sq, tid);
    load_rows<BWD_BQ, D, BWD_NT>(qs + QT, dO + q_head, stride, qt0, Sq, tid);
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

  // this warp's 16 keys, and this thread's two of them
  const int kr0 = 16 * warp;
  const int kw0 = k0 + kr0;
  const int krow[2] = {kw0 + g, kw0 + g + 8};
  // S^T and dP^T fragment offsets: K and V rows kr0 + g (+ 8), Q and dO
  // rows 8 n + g, chunk 4 kk + t4 -- every row g modulo 8, so (tf32x3.cuh)
  // the chunk is 4 (kk ^ sb) + ((t4 ^ sw) & 3)
  const int sw = swz<D, false>(g);
  const int sb = sw >> 2;
  const int a_lane = (kr0 + g) * D + 4 * ((t4 ^ sw) & 3);
  const int b_lane = g * D + 4 * ((t4 ^ sw) & 3);
  float dk_acc[NT][4];
  float dv_acc[NT][4];
  zero(dk_acc);
  zero(dv_acc);
  // dQ: this warp's 16 rows (tile half mt) and D / 4 columns
  const int mt = warp / 4;
  const int col0 = (warp % 4) * (D / 4);
  float* slot = dq_partial +
      (static_cast<size_t>(blockIdx.y) * gridDim.x + bh) * Sq * D;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * BWD_BQ;
    const float* qs = st_s + (t % 2) * 2 * QT;
    const float* dos = qs + QT;
    const float* lse_t = rows + (t % 2) * 2 * BWD_BQ;
    const float* delta_t = lse_t + BWD_BQ;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with t - 1
    if (t + 1 < n_tiles) {
      load_q_tile(t + 1);
      cp_async_commit();
    }

    // warp-uniform: some (key, row) pair of the warp is live
    if (kw0 < Sk && !(causal && kw0 > q0 + BWD_BQ - 1)) {
      // S^T = K Q^T and dP^T = V dO^T: [16 keys, 32 rows] over D, in
      // pairs of k8 slices
      float s[BWD_BQ / 8][4];
      float dp[BWD_BQ / 8][4];
      zero(s);
      zero(dp);
#pragma unroll 1
      for (int kk = 0; kk < D / 16; ++kk) {
        const int kx = 16 * (kk ^ sb);
        FragA ak[2];
        split_a(ak, *reinterpret_cast<const float4*>(k_s + a_lane + kx),
                *reinterpret_cast<const float4*>(k_s + a_lane + kx + 8 * D));
#pragma unroll
        for (int n = 0; n < BWD_BQ / 8; ++n) {
          FragB bq[2];
          split_b(bq, *reinterpret_cast<const float4*>(qs + b_lane + kx +
                                                       8 * n * D));
          float t[4];
          mma3_z(t, ak[0], bq[0]);
          mma3(t, ak[1], bq[1]);
          fold(s[n], t);
        }
      }
#pragma unroll 1
      for (int kk = 0; kk < D / 16; ++kk) {
        const int kx = 16 * (kk ^ sb);
        FragA av[2];
        split_a(av, *reinterpret_cast<const float4*>(v_s + a_lane + kx),
                *reinterpret_cast<const float4*>(v_s + a_lane + kx + 8 * D));
#pragma unroll
        for (int n = 0; n < BWD_BQ / 8; ++n) {
          FragB bdo[2];
          split_b(bdo, *reinterpret_cast<const float4*>(dos + b_lane + kx +
                                                        8 * n * D));
          float t[4];
          mma3_z(t, av[0], bdo[0]);
          mma3(t, av[1], bdo[1]);
          fold(dp[n], t);
        }
      }

      // p and dS per (key, row) pair; only tiles the diagonal crosses
      // mask.  s[n][i] is key krow[i / 2], row 8 n + 2 t4 + i % 2
      const bool diag = causal && kw0 + 15 > q0;
#pragma unroll
      for (int n = 0; n < BWD_BQ / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = 8 * n + 2 * t4 + i % 2;
          const int qi = q0 + qc;
          const int kj = krow[i / 2];
          pair_grad<float>(s[n][i], dp[n][i], lse_t[qc], delta_t[qc],
                           diag && kj > qi, qi < Sq && kj < Sk, scale,
                           scale_log2e, s[n][i], dp[n][i]);
        }
      }

      // P^T and dS^T to shared memory: A fragments of dV's and dK's
      // products, and in K3 dS^T also of the dQ product
      store_pairs(pt_s, s, kr0 + g, t4);
      if constexpr (DQ) {
#pragma unroll
        for (int n = 0; n < BWD_BQ / 8; ++n) {
          float* d0 = ds_s + (kr0 + g) * DS_LD + 8 * n + 2 * t4;
          *reinterpret_cast<float2*>(d0) = make_float2(dp[n][0], dp[n][1]);
          *reinterpret_cast<float2*>(d0 + 8 * DS_LD) =
              make_float2(dp[n][2], dp[n][3]);
        }
      } else {
        store_pairs(ds_s, dp, kr0 + g, t4);
      }
      __syncwarp();  // this warp's rows of both tiles are stored

      // dV += P^T dO, then dK += dS^T Q: k8 slices over the 32 rows, each
      // a fresh chain folded into the sum; lane g's B values of n8 tile
      // n sit in column g NT + n
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const float* bs = pass == 0 ? dos : qs;
#pragma unroll 1
        for (int j = 0; j < BWD_BQ / 8; ++j) {
          FragA pa;
          if (pass == 0 || !DQ) {
            split_pairs(pa, pass == 0 ? pt_s : ds_s, kr0 + g, j, t4);
          } else {
            const float* d0 = ds_s + (kr0 + g) * DS_LD + 8 * j + 2 * t4;
            const float2 a0 = *reinterpret_cast<const float2*>(d0);
            const float2 a8 = *reinterpret_cast<const float2*>(d0 + 8 * DS_LD);
            pa.set(0, a0.x);
            pa.set(1, a8.x);
            pa.set(2, a0.y);
            pa.set(3, a8.y);
          }
          const int r = 8 * j + 2 * t4;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 u0 = lds_chunk<D>(bs, r, NC * g + c);
            const float4 u1 = lds_chunk<D>(bs, r + 1, NC * g + c);
            const float x0[4] = {u0.x, u0.y, u0.z, u0.w};
            const float x1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              FragB bb;
              bb.set(0, x0[e]);
              bb.set(1, x1[e]);
              float t[4];
              mma3_z(t, pa, bb);
              fold(pass == 0 ? dv_acc[4 * c + e] : dk_acc[4 * c + e], t);
            }
          }
        }
      }
    } else if constexpr (DQ) {
#pragma unroll
      for (int n = 0; n < BWD_BQ / 8; ++n) {
        float* d0 = ds_s + (kr0 + g) * DS_LD + 8 * n + 2 * t4;
        *reinterpret_cast<float2*>(d0) = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(d0 + 8 * DS_LD) = make_float2(0.f, 0.f);
      }
    }
    if constexpr (!DQ) continue;  // K2b: no dQ, so no barrier for it
    __syncthreads();  // every warp's dS^T is stored

    // dQ = dS K over the block's live keys, [16 rows, D / 4 columns] a
    // warp: slice ks is keys 8 ks .. 8 ks + 7, A slot t4 key 2 t4 and
    // slot t4 + 4 key 2 t4 + 1, in dS^T and K alike
    const int live_keys = min(BWD_BK, min(Sk, causal ? q0 + BWD_BQ : Sk) - k0);
    const int n_ks = (live_keys + 7) / 8;
    float dq[NPW][4];
    zero(dq);
    const int bcol = col0 + NPW * dq_perm<D>(g);
    // fresh chains of four k8 slices (32 keys), folded into dq
    for (int ks0 = 0; ks0 < n_ks; ks0 += 4) {
      float t[NPW][4];
      zero(t);
      for (int ks = ks0; ks < min(ks0 + 4, n_ks); ++ks) {
        const float* da = ds_s + (8 * ks + 2 * t4) * DS_LD + 16 * mt + g;
        FragA a;
        a.set(0, da[0]);
        a.set(1, da[8]);
        a.set(2, da[DS_LD]);
        a.set(3, da[DS_LD + 8]);
        const int r = 8 * ks + 2 * t4;
        float x0[NPW];
        float x1[NPW];
        if constexpr (NPW == 4) {
          const float4 u0 = lds_chunk<D>(k_s, r, bcol / 4);
          const float4 u1 = lds_chunk<D>(k_s, r + 1, bcol / 4);
          x0[0] = u0.x; x0[1] = u0.y; x0[2] = u0.z; x0[3] = u0.w;
          x1[0] = u1.x; x1[1] = u1.y; x1[2] = u1.z; x1[3] = u1.w;
        } else {
          const float2 u0 = *reinterpret_cast<const float2*>(
              k_s + chunk_at<D>(r, bcol / 4) + bcol % 4);
          const float2 u1 = *reinterpret_cast<const float2*>(
              k_s + chunk_at<D>(r + 1, bcol / 4) + bcol % 4);
          x0[0] = u0.x; x0[1] = u0.y;
          x1[0] = u1.x; x1[1] = u1.y;
        }
#pragma unroll
        for (int n = 0; n < NPW; ++n) {
          FragB bk;
          bk.set(0, x0[n]);
          bk.set(1, x1[n]);
          mma3(t[n], a, bk);
        }
      }
#pragma unroll
      for (int n = 0; n < NPW; ++n) fold(dq[n], t[n]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qi = q0 + 16 * mt + g + 8 * hf;
      if (qi >= Sq) continue;
      float* out = slot + static_cast<size_t>(qi) * D + col0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // accumulator column 2 t4 + e of tile n
        float* dst = out + NPW * dq_perm<D>(2 * t4 + e);
        const int i = 2 * hf + e;
        if constexpr (NPW == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              dq[0][i], dq[1][i], dq[2][i], dq[3][i]);
        } else {
          *reinterpret_cast<float2*>(dst) =
              make_float2(dq[0][i], dq[1][i]);
        }
      }
    }
  }

  float* dkb = dk + k_head;
  float* dvb = dv + k_head;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kj = krow[hf];
    if (kj >= Sk) continue;
    const size_t at = static_cast<size_t>(kj) * stride;
    // accumulator column 2 t4 + e of tile n is D column (2 t4 + e) NT + n
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * hf + e;
      const size_t col = at + (2 * t4 + e) * NT;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        *reinterpret_cast<float4*>(dkb + col + 4 * c) = make_float4(
            dk_acc[4 * c][i], dk_acc[4 * c + 1][i],
            dk_acc[4 * c + 2][i], dk_acc[4 * c + 3][i]);
        *reinterpret_cast<float4*>(dvb + col + 4 * c) = make_float4(
            dv_acc[4 * c][i], dv_acc[4 * c + 1][i],
            dv_acc[4 * c + 2][i], dv_acc[4 * c + 3][i]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_NT, 1)
bwd_fused_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dq_partial,
                    int H, int Sq, int Sk, int causal, float scale,
                    float scale_log2e) {
  bwd_kv_walk_x3<D, true>(q, k, v, dO, lse2, delta, dk, dv, dq_partial, H,
                          Sq, Sk, causal, scale, scale_log2e);
}

template <int D>
__global__ void __launch_bounds__(BWD_NT, 1)
bwd_dkdv_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int H, int Sq, int Sk, int causal,
                   float scale, float scale_log2e) {
  bwd_kv_walk_x3<D, false>(q, k, v, dO, lse2, delta, dk, dv, nullptr, H, Sq,
                           Sk, causal, scale, scale_log2e);
}

// Pass 2: dq[b, qi, h, :] = the sum, in slot order, of the slots that
// wrote row qi -- under causal masking the 128-key blocks starting at or
// before the row, t <= qi / 128.
template <int D>
__global__ void __launch_bounds__(RED_NT)
dq_reduce_x3_kernel(const float* __restrict__ partial, float* __restrict__ dq,
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
  *reinterpret_cast<float4*>(
      dq + ((static_cast<size_t>(b) * Sq + qi) * H + h) * D + c) = sum;
}

// Both passes on `stream`; `partial` holds tc::bwd_slots(Sk) slots of
// [B*H, Sq, D] f32.
template <int D>
cudaError_t launch_bwd_fused_x3(const void* q, const void* k, const void* v,
                                const void* dO, const float* lse2,
                                const float* delta, void* dq, void* dk,
                                void* dv, float* partial, int B, int H,
                                int Sq, int Sk, int causal, float scale,
                                float scale_log2e, cudaStream_t stream) {
  const int slots = tc::bwd_slots(Sk);
  constexpr int smem = bwd_smem_bytes<D, true>();
  auto kernel = bwd_fused_x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, slots), BWD_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse2,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), partial, H,
      Sq, Sk, causal, scale, scale_log2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(B) * H * Sq * (D / 4);
  dq_reduce_x3_kernel<D><<<static_cast<unsigned>((n + RED_NT - 1) / RED_NT),
                           RED_NT, 0, stream>>>(
      partial, static_cast<float*>(dq), B * H, H, Sq, slots, causal);
  return cudaGetLastError();
}

// K2b on `stream`: one block per (batch-head, 128-key block).
template <int D>
cudaError_t launch_bwd_dkdv_x3(const void* q, const void* k, const void* v,
                               const void* dO, const float* lse2,
                               const float* delta, void* dk, void* dv, int B,
                               int H, int Sq, int Sk, int causal, float scale,
                               float scale_log2e, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<D, false>();
  auto kernel = bwd_dkdv_x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, tc::bwd_slots(Sk)), BWD_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO), lse2,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
      causal, scale, scale_log2e);
  return cudaGetLastError();
}

}  // namespace x3
}  // namespace dtf
