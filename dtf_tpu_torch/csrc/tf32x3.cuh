// The f32-accurate split product on Hopper's tensor cores (sm_90a):
// building blocks of the float32 routes of K1 (flash_fwd_x3.cuh), K2a
// (flash_bwd_dq_x3.cuh), K2b and K3 (flash_bwd_x3.cuh).
//
// The split ("3xTF32").  Each f32 operand x is written as hi + lo with
// hi = rna_tf32(x) and lo = rna_tf32(x - hi): TF32 keeps 10 stored
// mantissa bits, so |lo| <= 2^-11 |x| and the part of x that lo drops
// is at most 2^-11 |lo| <= 2^-22 |x|.  A product a.b is then
//   a_lo b_hi + a_hi b_lo + a_hi b_hi,
// three mma.sync.m16n8k8 TF32 products, smallest terms first, into one
// f32 accumulator; the dropped a_lo b_lo and the roundings of lo leave
// each product term within about 3 * 2^-22 = 7e-7 of its exact value,
// against f32's 2^-24.  Both halves are rounded to nearest (ties away,
// as cvt.rna): hi explicitly, since x - hi must be exact, and lo by
// adding half of the dropped 13 bits' range and letting the tensor
// core, which ignores an operand's low 13 bits, clear them.  Raw f32
// passed as "hi" would leave lo wrong by up to 2^-11 |x|.  (On the card,
// lo rounded explicitly, by cvt.rna, or by this add gives the same
// bits.)
//
// Accumulation.  The tensor core truncates the sum it forms inside an
// mma (toward zero), so an accumulator carried by a chain of N mmas
// drifts toward zero by up to about N/2 ulp of its size: carried through
// a whole 2048-row walk (768 mmas) dK and dV came out 2e-5 of their
// largest value off, twice the gate.  So no chain runs long: each run
// of one to four k8 slices starts a fresh accumulator (mma3_z) and is
// folded into the f32 sum with round-to-nearest adds (fold) -- S and dP
// every 16 values of D, O every 16 keys (folded with the rescale by
// the softmax correction, one fma), dK and dV every 8 rows, dQ every 32
// keys.  The gates this is held to: 1e-5 absolute on o and lse, 1e-5
// scaled on the gradients, against the exact f32 plain versions.
//
// Fragments (PTX ISA, mma.m16n8k8 with .tf32; g = lane / 4, t = lane %
// 4): A (16 x 8, row-major) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g); the
// f32 accumulator C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).  The kernels relabel both the contracted and the
// output dimension so that fragments are read 8 or 16 bytes at a time
// and no accumulator moves between lanes:
//   - contracted over D (S = Q K^T, dP = dO V^T): the 16 columns
//     16 kk .. 16 kk + 15 are two k8 slices; lane t's 16-byte chunk
//     4 kk + t gives slot t of slice 2 kk (column 16 kk + 4 t), slot
//     t + 4 (+ 1), slot t of slice 2 kk + 1 (+ 2) and slot t + 4 (+ 3),
//     for the A rows and the B rows alike;
//   - contracted over an accumulator's columns (O += P V, dV += P^T dO,
//     dK += dS^T Q): A slot t holds column 2t and slot t + 4 column
//     2t + 1 -- read back from a tile the accumulator was stored to
//     (pair_at), a = {c0, c2, c1, c3} -- and B is read from rows 2t and
//     2t + 1 of the k8 slice;
//   - output columns: lane g's B values of consecutive n8 tiles sit in
//     consecutive floats -- D column 16 p + 2 j + e for tile 2 p + e in
//     K1's O, j NT + n in K3's dK and dV (NT tiles), a permutation of
//     the warp's quarter in K3's dQ -- and the stores undo the map.
//
// Tiles live in shared memory as raw f32 [rows][D], no padding: the
// 16-byte chunks of row r are permuted by chunk ^ swz(r), which puts
// the lanes of each read phase on distinct banks.  Every row a lane
// reads is g, or 2t and 2t + 1, modulo 8, so the permutation is a lane
// constant and each fragment address a lane base plus a compile-time
// offset.  Each thread splits a fragment as it loads it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace dtf {
namespace x3 {

using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::smem_u32;

// threadIdx.x and blockIdx.x read afresh where they are used: a value
// derived from them once before a long loop would hold a register
// through it (and K1's walk has none to spare).
__device__ __forceinline__ int thread_x() {
  int x;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(x));
  return x;
}
__device__ __forceinline__ int block_x() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
  return x;
}

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TF32 round to nearest, ties away from zero -- cvt.rna.tf32.f32 for
// finite x -- as two integer instructions.  (cvt.rna compiles to a
// longer sequence with NaN handling, and the split runs on every
// operand element a warp loads.)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// One operand fragment, split: hi and lo TF32 registers of each value.
// lo's low 13 bits are left for the tensor core to ignore (see above).
template <int N>
struct Split {
  uint32_t hi[N];
  uint32_t lo[N];

  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = rna_tf32(x);
    lo[i] = __float_as_uint(x - __uint_as_float(hi[i])) + 0x1000u;
  }
};
using FragA = Split<4>;
using FragB = Split<2>;

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a.b, the tensor core's accumulator input zero.
__device__ __forceinline__ void mma_tf32_z(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a.b over one k8 slice: the three split products, smallest first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d = a.b over one k8 slice: a fresh chain.
__device__ __forceinline__ void mma3_z(float (&d)[4], const FragA& a,
                                       const FragB& b) {
  mma_tf32_z(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// acc += t with round-to-nearest f32 adds: where a fresh chain's sum
// joins the long one (see the note on accumulation above).
__device__ __forceinline__ void fold(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

template <int N, int M>
__device__ __forceinline__ void zero(float (&t)[N][M][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) t[n][m][i] = 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&t)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) t[n][i] = 0.f;
  }
}

// The A fragments of the two k8 slices of chunk 4 kk + t from the
// chunks of rows g and g + 8 (contracted over D, see above).
__device__ __forceinline__ void split_a(FragA (&a)[2], const float4& r0,
                                        const float4& r8) {
  a[0].set(0, r0.x);
  a[0].set(1, r8.x);
  a[0].set(2, r0.y);
  a[0].set(3, r8.y);
  a[1].set(0, r0.z);
  a[1].set(1, r8.z);
  a[1].set(2, r0.w);
  a[1].set(3, r8.w);
}

// The B fragments of the two k8 slices of one 16-byte chunk.
__device__ __forceinline__ void split_b(FragB (&b)[2], const float4& r) {
  b[0].set(0, r.x);
  b[0].set(1, r.y);
  b[1].set(0, r.z);
  b[1].set(1, r.w);
}

// A [rows][32] f32 tile of an accumulator (P or dS, keys or rows as
// its columns), stored so that it reads back as A fragments of the
// next product: float offset of the column pair 2u, 2u + 1 of row r,
// 8-byte units permuted by u ^ 4 (r % 4) -- a half-warp's reads and
// writes (rows g, units 4 j + t) then fall on 16 distinct bank pairs.
__device__ __forceinline__ int pair_at(int r, int u) {
  return r * 32 + 2 * (u ^ (4 * (r & 3)));
}

// The A fragment of k8 slice j (columns 8 j .. 8 j + 7, relabelled:
// slot t the column 2t, slot t + 4 the column 2t + 1) of rows r0 and
// r0 + 8 of such a tile.
__device__ __forceinline__ void split_pairs(FragA& a, const float* tile,
                                            int r0, int j, int t) {
  const float2 p0 =
      *reinterpret_cast<const float2*>(tile + pair_at(r0, 4 * j + t));
  const float2 p8 =
      *reinterpret_cast<const float2*>(tile + pair_at(r0 + 8, 4 * j + t));
  a.set(0, p0.x);
  a.set(1, p8.x);
  a.set(2, p0.y);
  a.set(3, p8.y);
}

// Stores an m16 tile's four n8 accumulators (rows r0, r0 + 8; columns
// 8 n + 2t, 8 n + 2t + 1) into such a tile.
__device__ __forceinline__ void store_pairs(float* tile, const float (&c)[4][4],
                                            int r0, int t) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float2*>(tile + pair_at(r0, 4 * n + t)) =
        make_float2(c[n][0], c[n][1]);
    *reinterpret_cast<float2*>(tile + pair_at(r0 + 8, 4 * n + t)) =
        make_float2(c[n][2], c[n][3]);
  }
}

// The chunk permutations of row r of a [rows][D] f32 tile.
//
// Tiles read contracted over D (and, in K3, also along output columns):
// for D 128 (32 chunks a row) bits 0-1 from r / 2 and bit 2 from r % 2;
// for D 64 (16 chunks) bit 0 from r / 2 and bit 2 from r / 4 ^ r.  Rows
// 2p and 2p + 1 differ in bit 2 (a quarter-warp's rows g of chunks
// 4 kk + t), and the even rows of an 8-row group, like the odd ones,
// differ in the bits that the chunk index of lanes g = 0, 1 leaves free
// (rows 2t of chunks g NC + c).
//
// Tiles read in column pairs (K1's V, PAIRS): bits 1-2 from r / 2, so
// that a half-warp's 16 eight-byte reads -- rows 2t, the pair of
// columns 16 p + 2g -- fall on 16 distinct bank pairs.
template <int D, bool PAIRS>
__device__ __forceinline__ int swz(int r) {
  static_assert(D == 64 || D == 128, "head dims 64 and 128");
  if constexpr (PAIRS) {
    return ((r >> 1) & 3) << 1;
  } else if constexpr (D == 128) {
    return ((r >> 1) & 3) | ((r & 1) << 2);
  } else {
    return ((r >> 1) & 1) | ((((r >> 2) ^ r) & 1) << 2);
  }
}

// Float offset of 16-byte chunk `ch` of row r.
template <int D, bool PAIRS = false>
__device__ __forceinline__ int chunk_at(int r, int ch) {
  return r * D + ((ch ^ swz<D, PAIRS>(r)) << 2);
}

template <int D>
__device__ __forceinline__ float4 lds_chunk(const float* tile, int r,
                                            int ch) {
  return *reinterpret_cast<const float4*>(tile + chunk_at<D>(r, ch));
}

// Issue the copies of rows [row0, row0 + ROWS) of one head of a
// [B, S, H, D] f32 tensor into the swizzled tile dst[ROWS][D]; `base`
// points at (b, 0, h, 0), `stride` is H * D, rows at or past S are
// zero-filled.  NT threads share the copies, 16 bytes each: a thread
// keeps one chunk column and steps down the rows, so every copy's
// addresses are one running pointer and a few shared-memory bases plus
// compile-time offsets -- nothing the walk has to hold per copy.
template <int ROWS, int D, int NT, bool PAIRS = false>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          size_t stride, int row0, int S,
                                          int tid) {
  constexpr int CPR = D / 4;     // 16-byte chunks per row
  constexpr int RPI = NT / CPR;  // rows per step
  // the chunk permutation repeats every 8 rows
  constexpr int P = RPI % 8 == 0 ? 1 : 8 / RPI;
  static_assert(NT % CPR == 0 && ROWS % (RPI * P) == 0, "copies split evenly");
  const int c = tid % CPR;
  const int r0 = tid / CPR;
  uint32_t at[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    at[p] = smem_u32(dst + chunk_at<D, PAIRS>(r0 + p * RPI, c));
  }
  const float* src = base + static_cast<size_t>(row0 + r0) * stride + 4 * c;
#pragma unroll
  for (int it = 0; it < ROWS / RPI; ++it) {
    const bool valid = row0 + r0 + it * RPI < S;
    cp_async16(at[it % P] + (it / P) * P * RPI * D * 4, valid ? src : base,
               valid);
    src += RPI * stride;
  }
}

}  // namespace x3
}  // namespace dtf
