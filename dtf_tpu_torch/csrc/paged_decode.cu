// K4 -- paged flash decode for Hopper (sm_90a).
//
// Replaces the TPU kernel dtf_tpu/ops/paged_attention.py
// `_paged_decode_kernel` (launched by `paged_flash_decode`): the S
// queries of each batch row attend over that row's KV history, read from
// the shared page pool THROUGH the row's block table inside the kernel,
// so no gathered window ever exists in device memory.  Query i of row b
// sits at position index[b] + i and admits key p iff p <= index[b] + i
// (write-then-attend: the chunk's own K/V are already in the pool).
// Keys past a row's live length, index[b] + S, are never read: the
// dead-page skip of the TPU kernel.  The carry (o, m, l) is f32, the
// same rule as the flash kernels; in bf16, P is rounded to bf16 before
// P V.
//
// What bounds it on the card: bytes.  A decode step (S = 1) and a
// continuation chunk (S = 64) do O(S L D) work over O(L D) bytes of K/V
// -- the live pages read once.  The TPU kernel walks a row's pages in
// order on one core; on 132 SMs one walk per (row, head) leaves most of
// the card idle (48 blocks at 8 rows x 6 heads) and pays one memory
// latency per tile.  So the walk is split over the SMs:
//
//   split pass -- grid (n_split, query tiles, B * H): each block takes
//     one (row, head), a tile of its queries and one split of the row's
//     keys, [sp kps, (sp + 1) kps), and writes its un-normalized f32
//     partial o_s, m_s, l_s (paged_split.cuh).  n_split = ceil(M page /
//     kps) is sized on the host from the table's width -- reading index
//     there would synchronize -- and a split past the row's live length
//     exits at once, marked empty.
//   combine   -- paged_split.cuh paged_combine_kernel: the partials of
//     each query row folded in split order, o = sum 2^(m_s - M) o_s /
//     sum 2^(m_s - M) l_s.  No atomics: the same bits on every run.
//
// So a call is two device kernels (the profiler sees both) and one
// launch on the wrapper's count.  The keys per split, kps, is the
// wrapper's KEYS_PER_SPLIT, a multiple of 64; the route is chosen here
// by S alone:
//
//   S < CHUNK_MIN_S (decode) -- paged_split_cc_kernel below, CUDA cores,
//     both dtypes.  With S = 1 there is no row dimension for a tensor-core
//     product; the work is bytes, so the design keeps bytes in flight.
//     Each block (four warps) streams its split's K and V rows through a
//     four-stage cp.async ring of 8 KB tiles, three tiles ahead of use,
//     each key row looked up through the block table.  Every warp works:
//     a key's head row is LPK = D sizeof(T) / 16 lanes, each with a
//     16-byte slice (a half-warp per key at bf16 D 128); the dot product
//     is the slices' partial sums reduced by shuffles inside the lane
//     group, and the lanes own the same slices' columns of the P V sum.
//     Each lane group keeps its own online-softmax carry over its keys,
//     four keys a step; the carries of the block's lane groups are folded
//     in a fixed order at the end.  One block per (row, head, split):
//     each key read is one 128- to 512-byte head row.
//   S >= CHUNK_MIN_S (chunks) -- the tensor cores, K1's tile walks with
//     a paged row address: bf16 wgmma (paged_decode_tc.cuh), f32 the
//     split-TF32 mma.sync (paged_decode_x3.cuh), 64 query rows a block.
//
// Layout: q, o [B, S, H, D]; pool_k, pool_v [P, page, H, D]; table
// [B, M] int32 page ids; index [B] int32; D 64 or 128.  Rows whose table
// is all zeros read the scratch page 0; the engine ignores their output.
// Page ids are clamped into [0, P), as the gather they replace clamps
// out-of-range indices.
#include "paged_decode_tc.cuh"
#include "paged_decode_x3.cuh"
#include "paged_split.cuh"

namespace dtf {
namespace paged {

constexpr int CHUNK_MIN_S = 16;      // S at which the chunk routes begin
constexpr int KPS_MULTIPLE = 64;     // kps is a multiple of the key tiles
constexpr int DEC_NW = 4;            // warps a block
constexpr int DEC_NT = 32 * DEC_NW;
constexpr int DEC_STAGES = 4;        // depth of the copy ring
constexpr int DEC_TILE_BYTES = 8192; // a stage's K tile (and its V tile)
constexpr int DEC_QG = 4;            // query rows a block when 1 < S < 16
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int D>
struct DecodeShape {
  static constexpr int VEC = 16 / sizeof(T);       // elements a lane loads
  static constexpr int LPK = D / VEC;              // lanes per key
  static constexpr int G = 32 / LPK;               // lane groups a warp
  static constexpr int ROW = D * sizeof(T);        // bytes of a head row
  static constexpr int TK = DEC_TILE_BYTES / ROW;  // keys a stage
  static constexpr int KW = TK / DEC_NW;           // keys a warp a stage
  static constexpr int KB = KW / G;                // keys a lane group
  static constexpr int STAGE = 2 * DEC_TILE_BYTES;
  static constexpr int SMEM = DEC_STAGES * STAGE;
  static_assert(KB >= 1 && KW == G * KB, "lane groups split a warp's keys");
  // the fold of the lane groups' carries reuses the ring
  static_assert(DEC_NW * G * DEC_QG * (D + 2) * sizeof(float) <= SMEM,
                "carries fit the ring");
};

// Grid (n_split, ceil(S / QG), B * H): QG query rows a block.
template <typename T, int D, int QG>
__global__ void __launch_bounds__(DEC_NT)
paged_split_cc_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                      const T* __restrict__ pool_v,
                      const int* __restrict__ table,
                      const int* __restrict__ index,
                      float* __restrict__ o_part,
                      float* __restrict__ ml_part, int S, int H, int P,
                      int page, int M, int kps, float scale_log2e) {
  using Sh = DecodeShape<T, D>;
  constexpr int VEC = Sh::VEC;
  constexpr int LPK = Sh::LPK;
  constexpr int G = Sh::G;
  extern __shared__ __align__(16) uint8_t ring_raw[];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / LPK;  // this lane's group: its keys
  const int c = lane % LPK;    // its 16-byte slice of a head row
  const int sp = blockIdx.x;
  const int q0 = blockIdx.y * QG;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh % H;
  const int rows = min(QG, S - q0);
  const int start = index[b];
  const KeyRange kr = split_keys(sp, kps, start, q0, rows, M * page);
  const size_t prow = part_row(bh, sp, gridDim.x, S, q0);
  if (kr.lo >= kr.hi) {
    mark_empty(ml_part, prow, rows, tid, DEC_NT);
    return;
  }
  const int* tbl = table + static_cast<size_t>(b) * M;
  const int n_tiles = (kr.hi - kr.lo + Sh::TK - 1) / Sh::TK;
  const uint32_t ring = tc::smem_u32(ring_raw);

  // the copies of tile t (keys kr.lo + t TK ..) into stage t % STAGES:
  // rows at or past the split's end zero-filled
  auto issue = [&](int t) {
    const int k0 = kr.lo + t * Sh::TK;
    const uint32_t st = ring + (t % DEC_STAGES) * Sh::STAGE;
#pragma unroll
    for (int it = 0; it < Sh::TK * LPK / DEC_NT; ++it) {
      const int idx = tid + it * DEC_NT;
      const int r = idx / LPK;
      const int ch = idx % LPK;
      const bool valid = k0 + r < kr.hi;
      const size_t off =
          (valid ? key_offset(tbl, k0 + r, page, P, H, h, D) : 0) + ch * VEC;
      const uint32_t at = st + r * Sh::ROW + ch * 16;
      tc::cp_async16(at, pool_k + off, valid);
      tc::cp_async16(at + DEC_TILE_BYTES, pool_v + off, valid);
    }
  };
#pragma unroll
  for (int t = 0; t < DEC_STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    tc::cp_async_commit();
  }

  // this lane's slice of each query row (rows past S are zero)
  float qv[QG][VEC];
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    if (i < rows) {
      load_vec(q + ((static_cast<size_t>(b) * S + q0 + i) * H + h) * D +
                   c * VEC,
               qv[i]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[i][e] = 0.f;
    }
  }
  const int qpos0 = start + q0;
  float o_acc[QG][VEC];
  float m[QG];
  float l[QG];
#pragma unroll
  for (int i = 0; i < QG; ++i) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) o_acc[i][e] = 0.f;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    x3::cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + DEC_STAGES - 1 < n_tiles) issue(t + DEC_STAGES - 1);
    tc::cp_async_commit();
    const uint8_t* st = ring_raw + (t % DEC_STAGES) * Sh::STAGE;
    const int k0 = kr.lo + t * Sh::TK;
    // this lane group's keys of the tile: warp KW + j G + grp
    float s[QG][Sh::KB];
#pragma unroll
    for (int j = 0; j < Sh::KB; ++j) {
      const int kt = warp * Sh::KW + j * G + grp;
      float kf[VEC];
      load_vec(reinterpret_cast<const T*>(st + kt * Sh::ROW) + c * VEC, kf);
#pragma unroll
      for (int i = 0; i < QG; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc = fmaf(qv[i][e], kf[e], acc);
        s[i][j] = acc;
      }
    }
    // the dot products: the slices' sums over the group's LPK lanes
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < QG; ++i) {
#pragma unroll
        for (int j = 0; j < Sh::KB; ++j) {
          s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
        }
      }
    }
    // online softmax over the group's keys in base 2: masked past the
    // split's end and past each row's position
#pragma unroll
    for (int i = 0; i < QG; ++i) {
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < Sh::KB; ++j) {
        const int kp = k0 + warp * Sh::KW + j * G + grp;
        float x = s[i][j] * scale_log2e;
        if (kp >= kr.hi || kp > qpos0 + i) x += NEG_INF;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], mt);
      const float m_safe = fmaxf(m_new, NEG_INF);
      const float corr = exp2f(m[i] - m_safe);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < Sh::KB; ++j) {
        const float p = exp2f(s[i][j] - m_safe);
        ls += p;
        s[i][j] = round_as<T>(p);
      }
      l[i] = l[i] * corr + ls;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o_acc[i][e] *= corr;
    }
    // O += P V over the same keys; this lane's slice of each V row
#pragma unroll
    for (int j = 0; j < Sh::KB; ++j) {
      const int kt = warp * Sh::KW + j * G + grp;
      float vf[VEC];
      load_vec(reinterpret_cast<const T*>(st + DEC_TILE_BYTES + kt * Sh::ROW) +
                   c * VEC,
               vf);
#pragma unroll
      for (int i = 0; i < QG; ++i) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          o_acc[i][e] = fmaf(s[i][j], vf[e], o_acc[i][e]);
        }
      }
    }
  }

  // fold the NW G lane groups' carries, in order, through the ring's
  // memory: co[slot][i][D] and cml[slot][i][2], slot = warp G + grp
  x3::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* co = reinterpret_cast<float*>(ring_raw);
  float* cml = co + DEC_NW * G * QG * D;
  const int slot = warp * G + grp;
#pragma unroll
  for (int i = 0; i < QG; ++i) {
    float* dst = co + (slot * QG + i) * D + c * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = o_acc[i][e];
    if (c == 0) {
      cml[2 * (slot * QG + i)] = m[i];
      cml[2 * (slot * QG + i) + 1] = l[i];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * D; idx += DEC_NT) {
    const int i = idx / D;
    const int col = idx % D;
    float mx = NEG_INF;
    for (int sl = 0; sl < DEC_NW * G; ++sl) {
      mx = fmaxf(mx, cml[2 * (sl * QG + i)]);
    }
    float acc = 0.f;
    float lsum = 0.f;
    for (int sl = 0; sl < DEC_NW * G; ++sl) {
      const float w = exp2f(cml[2 * (sl * QG + i)] - mx);
      acc += w * co[(sl * QG + i) * D + col];
      lsum += w * cml[2 * (sl * QG + i) + 1];
    }
    o_part[(prow + i) * D + col] = acc;
    if (col == 0) {
      ml_part[2 * (prow + i)] = mx;
      ml_part[2 * (prow + i) + 1] = lsum;
    }
  }
}

template <typename T, int D, int QG>
cudaError_t launch_split_cc(const void* q, const void* pk, const void* pv,
                            const int* table, const int* index,
                            float* o_part, float* ml_part, int B, int S,
                            int H, int P, int page, int M, int kps,
                            int n_split, float scale_log2e,
                            cudaStream_t stream) {
  constexpr int smem = DecodeShape<T, D>::SMEM;
  auto kernel = paged_split_cc_kernel<T, D, QG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, (S + QG - 1) / QG, B * H);
  kernel<<<grid, DEC_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), table, index, o_part, ml_part, S, H, P, page,
      M, kps, scale_log2e);
  return cudaGetLastError();
}

// The split pass of the route S picks.  A decode step (S = 1) runs one
// query row a block; a few queries (S < CHUNK_MIN_S) DEC_QG.
template <typename T, int D>
cudaError_t launch_split(const void* q, const void* pk, const void* pv,
                         const int* table, const int* index, float* o_part,
                         float* ml_part, int B, int S, int H, int P,
                         int page, int M, int kps, int n_split,
                         float scale_log2e, cudaStream_t stream) {
  if (S == 1) {
    return launch_split_cc<T, D, 1>(q, pk, pv, table, index, o_part, ml_part,
                                    B, S, H, P, page, M, kps, n_split,
                                    scale_log2e, stream);
  }
  if (S < CHUNK_MIN_S) {
    return launch_split_cc<T, D, DEC_QG>(q, pk, pv, table, index, o_part, ml_part,
                                    B, S, H, P, page, M, kps, n_split,
                                    scale_log2e, stream);
  }
  if constexpr (sizeof(T) == 2) {
    return launch_split_tc<D>(q, pk, pv, table, index, o_part, ml_part, B, S,
                              H, P, page, M, kps, n_split, scale_log2e,
                              stream);
  } else {
    return launch_split_x3<D>(q, pk, pv, table, index, o_part, ml_part, B, S,
                              H, P, page, M, kps, n_split, scale_log2e,
                              stream);
  }
}

template <typename T, int D>
cudaError_t run(const void* q, const void* pk, const void* pv,
                const int* table, const int* index, void* o, float* o_part,
                float* ml_part, int B, int S, int H, int P, int page, int M,
                int kps, float scale, cudaStream_t stream) {
  const int n_split = (M * page + kps - 1) / kps;
  if (n_split > 0) {
    const cudaError_t err =
        launch_split<T, D>(q, pk, pv, table, index, o_part, ml_part, B, S, H,
                           P, page, M, kps, n_split, scale * LOG2E, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_combine<T, D>(o_part, ml_part, o, B, S, H, n_split, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* pk, const void* pv,
                       const int* table, const int* index, void* o,
                       float* o_part, float* ml_part, int B, int S, int H,
                       int D, int P, int page, int M, int kps, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 64:
      return run<T, 64>(q, pk, pv, table, index, o, o_part, ml_part, B, S, H,
                        P, page, M, kps, scale, stream);
    case 128:
      return run<T, 128>(q, pk, pv, table, index, o, o_part, ml_part, B, S,
                         H, P, page, M, kps, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace paged
}  // namespace dtf

// dtype: 0 = float32, 1 = bfloat16.  o_part and ml_part are the
// partials' scratch, B * H * n_split * S * D and B * H * n_split * S * 2
// floats with n_split = ceil(M * page / kps); kps a positive multiple of
// 64.  Returns the first launch's cudaError_t.
extern "C" int dtf_paged_decode(const void* q, const void* pool_k,
                                const void* pool_v, const int* table,
                                const int* index, void* o, float* o_part,
                                float* ml_part, int B, int S, int H, int D,
                                int P, int page, int M, int kps, int dtype,
                                float scale, void* stream) {
  using namespace dtf::paged;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kps <= 0 || kps % KPS_MULTIPLE != 0 || page <= 0) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return dispatch_d<float>(q, pool_k, pool_v, table, index, o, o_part,
                             ml_part, B, S, H, D, P, page, M, kps, scale, s);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(q, pool_k, pool_v, table, index, o,
                                     o_part, ml_part, B, S, H, D, P, page, M,
                                     kps, scale, s);
  }
  return cudaErrorInvalidValue;
}
