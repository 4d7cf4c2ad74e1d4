// Hopper (sm_90a) building blocks of the tensor-core attention kernels
// (flash_fwd_tc.cuh: K1 in bf16; flash_bwd_tc.cuh: K3 and K2b in bf16;
// flash_bwd_dq_tc.cuh: K2a in bf16).
//
// Shared-memory tiles.  A tile of ROWS rows x COLS bf16 columns (COLS a
// multiple of 64) is stored as COLS / 64 "panels" of [ROWS][64]: each
// row of a panel is 128 bytes, and its eight 16-byte chunks are
// permuted by the 128-byte swizzle -- chunk c of row r sits at chunk
// c ^ (r % 8) -- so that the eight rows of a wgmma core matrix fall on
// distinct banks.  Panels start on 1024-byte boundaries (the swizzle
// pattern repeats every 8 rows = 1024 bytes and is keyed to address
// bits, not to the tile).
//
// One panel layout serves both operand majors of wgmma:
//   K-major (the contracted dim runs along a row): rows are M or N,
//     8-row groups 1024 bytes apart (SBO), a k16 step moves the start
//     32 bytes along the row, panel p holds k in [64p, 64p + 64);
//   MN-major (the contracted dim runs down the rows, the transpose bit
//     set): rows are K, 8-row groups 1024 bytes apart (SBO), a k16 step
//     moves the start 16 rows = 2048 bytes, and the next 64 M or N
//     columns lie one panel further (LBO = panel bytes).
//
// Copies are cp.async (16 bytes a thread, zero-filled past the sequence
// end), not TMA: the kernels keep their [B, S, H, D] addressing and the
// ragged-tail masking in plain code, and need no TMA tensor map
// (cuTensorMapEncodeTiled, from libcuda).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtf {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `valid` false zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte asynchronous copy (the f32 row statistics), zero-filled when
// not `valid`.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes (cp.async or st.shared)
// visible to the async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of (row, col) in a tile of ROWS-row panels.
template <int ROWS>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return (col / 64) * (ROWS * 128) + row * 128 +
         ((((col % 64) / 8) ^ (row % 8)) << 4) + (col % 8) * 2;
}

// Issue the copies of rows [row0, row0 + ROWS) of one head of a
// [B, S, H, D]-laid-out tensor into the swizzled tile at `dst`; `base`
// points at (b, 0, h, 0), `stride` is H * D elements, rows at or past
// `S` are zero-filled.  NT threads share the copies, neighbouring
// threads on neighbouring 16-byte chunks of a row.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* base,
                                          size_t stride, int row0, int S,
                                          int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CPR % NT == 0, "copies split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int idx = tid + it * NT;
    const int r = idx / CPR;
    const int c = idx % CPR;
    const bool valid = row0 + r < S;
    const bf16* src = base + (valid ? static_cast<size_t>(row0 + r) * stride
                                    : 0) + c * 8;
    cp_async16(dst + tile_offset<ROWS>(r, c * 8), src, valid);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; `lbo` and
// `sbo` in bytes (see the layout note above).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers at this point of the program: the compiler sees wgmma's
// asynchronous reads and writes of accumulators and A fragments as
// happening at issue, so each operand array is "touched" after the
// wait (and before the issue) to keep it in place meanwhile.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void pin(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Element i of a thread's m64nN f32 accumulator (N / 2 per thread)
// lies at row 16 * warp + lane / 4 + 8 * acc_half(i) of the warpgroup's
// 64 rows, column acc_col(i, lane).  The same layout, two accumulator
// entries to one 32-bit register, is the A-fragment layout of a k16
// slice: A register r of slice kk packs entries 8 kk + 2 r and
// 8 kk + 2 r + 1 (pack_a).
__device__ __forceinline__ constexpr int acc_half(int i) {
  return (i / 2) % 2;
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of an m64nN accumulator's N / 16 k16 slices, each
// value rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(const float (&acc)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
    }
  }
}

// The warpgroup products: m64nNk16, bf16 operands, f32 accumulators.
// mma_ss: A and B from shared memory (descriptors); mma_rs: A from
// registers (four 32-bit registers of bf16 pairs), B from shared
// memory.  TA / TB: 0 = K-major, 1 = MN-major (transposed).
// `accumulate` 0 overwrites d with A.B, 1 adds A.B to it.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

// m64nNk16 with A from registers, N = D (64 or 128).
template <int D, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  if constexpr (D == 64) {
    mma_rs_n64<TB>(d, a, b, accumulate);
  } else {
    static_assert(D == 128, "head dims 64 and 128");
    mma_rs_n128<TB>(d, a, b, accumulate);
  }
}

}  // namespace tc
}  // namespace dtf
