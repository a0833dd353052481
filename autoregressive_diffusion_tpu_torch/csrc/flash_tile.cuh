// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): type helpers, the frame-mask predicate, the
// ring-cache prefill mask, the tile-skipping tests, the fp32 kernels'
// staging of a 64-row tile in shared memory, and the bf16 kernels'
// tensor-core tiles (TMA loads, wgmma products, accumulator fragments).
//
// Layout: q, o, dq and dO are (B*H, Sq, D) row-major, k, v, dk and dv
// (B*H, Sk, D); lse and delta are (B*H, Sq) fp32. Sq = Sk but under sequence
// parallelism, where the queries are one seq rank's rows and the keys those
// of all sp ranks (Sk = sp * Sq), and in the ring-cache prefill, where the
// queries are the new frames and the keys the ring's f_total slots. The fp32 kernels work on 64 rows with 256
// threads, four neighbouring lanes of one warp to a row; the bf16 kernels
// on 64 rows with one warpgroup of 128 threads, each thread holding two rows
// of the wgmma accumulator.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_tc.cuh"

namespace adflash {

constexpr int BQ = 64;   // query rows of a tile
constexpr int BK = 64;   // key rows of a tile
constexpr int NT = 256;  // threads: 4 per row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// n / d for 0 <= n < 2^31 by a multiply and a shift (the round-up method:
// mul = ceil(2^(31 + l) / d) with 2^l >= d, so the error stays below 1/d):
// the frame tests divide token and frame indices by runtime widths.
struct FastDiv {
  int d;
  uint32_t mul;
  int shr;
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((uint32_t)n, mul) >> shr);
  }
};

inline FastDiv make_fastdiv(int d) {
  if (d <= 1) return FastDiv{1, 0u, 0};  // (d < 1 only for a divider the mask never uses)
  int l = 0;
  while ((1ll << l) < d) ++l;
  return FastDiv{d, (uint32_t)(((1ull << (31 + l)) + (uint64_t)d - 1) / (uint64_t)d), l - 1};
}

// The mask: kind 0 = DART over 2 * n_frames frames of hw tokens, 1 = full,
// 2 = frame-causal over n_frames frames. Under sequence parallelism the
// queries are the rows of one seq rank and the keys the rows of all ranks,
// rank-major: t_local is the number of frames a rank holds of each DART
// half (of the causal run) and q_frame0 the gathered frame index of the
// rank's first query frame. Without it, t_local = n_frames and q_frame0 = 0.
// by_hw and by_span divide by hw and 2 t_local.
struct Mask {
  int kind;
  int n_frames;
  int hw;
  int t_local;
  int q_frame0;
  FastDiv by_hw;
  FastDiv by_span;
};

// The global frame of gathered frame j, ops/masks.py::shard_frame: under
// DART rank rho = j / (2 t_local) holds clean frames [rho t_local,
// (rho + 1) t_local), then the same frames noisy. The identity for one rank
// and for the causal and full kinds. SHARD is false for the one-rank entry
// points, so their kernels compile to no mapping at all (t_local and
// q_frame0 unread), as before sequence parallelism was added.
template <bool SHARD>
__device__ __forceinline__ int shard_frame(const Mask& m, int j) {
  if (!SHARD || m.kind != 0) return j;
  const int rho = m.by_span.div(j), r = j - rho * 2 * m.t_local;
  return r < m.t_local ? rho * m.t_local + r : m.n_frames + rho * m.t_local + (r - m.t_local);
}

// The rule of ops/masks.py::frame_visible on the global frames of local
// query frame qf and gathered key frame kf: a clean query frame (< T) sees
// frames <= it; a noisy one sees clean frames < it - T and itself; under
// the causal kind every frame sees the frames <= it.
template <bool SHARD>
__device__ __forceinline__ bool frame_visible(const Mask& m, int qf, int kf) {
  if (m.kind == 1) return true;
  const int q = shard_frame<SHARD>(m, SHARD ? qf + m.q_frame0 : qf);
  const int k = shard_frame<SHARD>(m, kf);
  if (m.kind == 2 || q < m.n_frames) return k <= q;
  return k == q || k < q - m.n_frames;
}

template <bool SHARD>
__device__ __forceinline__ bool token_visible(const Mask& m, int qi, int kj) {
  return m.kind == 1 || frame_visible<SHARD>(m, m.by_hw.div(qi), m.by_hw.div(kj));
}

// Whether any query row in [q0, q1] sees any key in [k0, k1] (inclusive,
// inside Sq and Sk), from frame indices alone: exact, since every frame
// pair of the two tiles is tested, wherever the tiles straddle a frame or a
// clean/noisy boundary. Depends only on its arguments, so a whole block
// agrees on it.
template <bool SHARD>
__device__ __forceinline__ bool tile_visible(const Mask& m, int q0, int q1, int k0, int k1) {
  if (m.kind == 1) return true;
  const int qf1 = m.by_hw.div(q1), kf0 = m.by_hw.div(k0), kf1 = m.by_hw.div(k1);
  for (int qf = m.by_hw.div(q0); qf <= qf1; ++qf)
    for (int kf = kf0; kf <= kf1; ++kf)
      if (frame_visible<SHARD>(m, qf, kf)) return true;
  return false;
}

// Whether every query row in [q0, q1] sees every key in [k0, k1], from
// frame indices alone: then a tile needs no per-token test.
template <bool SHARD>
__device__ __forceinline__ bool tile_whole(const Mask& m, int q0, int q1, int k0, int k1) {
  if (m.kind == 1) return true;
  const int qf1 = m.by_hw.div(q1), kf0 = m.by_hw.div(k0), kf1 = m.by_hw.div(k1);
  for (int qf = m.by_hw.div(q0); qf <= qf1; ++qf)
    for (int kf = kf0; kf <= kf1; ++kf)
      if (!frame_visible<SHARD>(m, qf, kf)) return false;
  return true;
}

// Stage rows [row0, row0 + 64) of a (S, D) matrix as fp32 into dst with a
// padded row stride D + 1 (conflict-free column reads); rows past S are 0.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int row0, int S) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int g = row0 + r;
    dst[r * LD + c] = g < S ? src[(size_t)g * D + c] : 0.f;
  }
}

// The row's four lanes are neighbours in one warp.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The mask of one call, checked: returns false for arguments the kernels do
// not take. sp_rank < 0: one rank, Sq = Sk (DART: 2 * n_frames * hw tokens,
// causal: n_frames * hw). sp_rank >= 0: the queries of seq rank sp_rank
// against the keys of all Sk / Sq ranks (DART or causal).
inline bool make_mask(int kind, int Sq, int Sk, int n_frames, int hw, int sp_rank, Mask* m) {
  if (Sq <= 0 || Sk <= 0 || hw <= 0 || kind < 0 || kind > 2) return false;
  if (sp_rank < 0) {
    if (Sq != Sk) return false;
    if (kind == 0 && Sq != 2 * n_frames * hw) return false;
    if (kind == 2 && Sq != n_frames * hw) return false;
    *m = Mask{kind, n_frames, hw, n_frames, 0, make_fastdiv(hw), make_fastdiv(2 * n_frames)};
    return true;
  }
  if (kind == 1 || Sk % Sq != 0) return false;
  const int sp = Sk / Sq;
  const int fq = Sq / hw;  // query frames of the rank
  if (Sq % hw != 0 || sp_rank >= sp) return false;
  if (kind == 0) {
    if (fq % 2 != 0 || n_frames != sp * (fq / 2)) return false;
    *m = Mask{0, n_frames, hw, fq / 2, sp_rank * fq, make_fastdiv(hw), make_fastdiv(fq)};
  } else {
    if (n_frames != sp * fq) return false;
    *m = Mask{2, n_frames, hw, fq, sp_rank * fq, make_fastdiv(hw), make_fastdiv(2 * fq)};
  }
  return true;
}

// The ring-cache prefill mask (ops/masks.py::prefill_frame_mask): the Sq =
// t_new * hw query rows are frames at absolute positions offset, offset + 1,
// ..., the Sk = f_total * hw keys the f_total slots of the ring; once the
// new frames land (end = offset + t_new) slot s holds frame p(s) = end - 1 -
// ((end - 1 - s) mod f_total), and query frame f sees slot s iff 0 <= p(s)
// <= offset + f. The fresh causal prefill is offset 0, f_total = t_new.
// by_hw and by_f divide by hw and f_total. token_visible and tile_whole
// take a RingMask in place of a Mask (SHARD is unused); visibility only
// grows with the query frame, so a tile is whole if its oldest query frame
// sees all of its slots (ring_tiles below finds the visible tiles).
struct RingMask {
  int hw;
  int f_total;
  int offset;
  int end;
  FastDiv by_hw;
  FastDiv by_f;
  int split;  // blocks (a thread-block cluster) that share a query tile's key tiles
};

constexpr int RING_NSTAGE = 4;  // ring stages of the prefill kernel's streamed tiles

__device__ __forceinline__ bool ring_visible(const RingMask& m, int qf, int s) {
  const int n = m.end - 1 - s + m.f_total;  // > 0, as s < f_total and end >= 1
  const int p = m.end - 1 - (n - m.f_total * m.by_f.div(n));
  return p >= 0 && p <= m.offset + qf;
}

template <bool SHARD>
__device__ __forceinline__ bool token_visible(const RingMask& m, int qi, int kj) {
  return ring_visible(m, m.by_hw.div(qi), m.by_hw.div(kj));
}

template <bool SHARD>
__device__ __forceinline__ bool tile_whole(const RingMask& m, int q0, int q1, int k0, int k1) {
  const int qf = m.by_hw.div(q0), s1 = m.by_hw.div(k1);
  for (int s = m.by_hw.div(k0); s <= s1; ++s)
    if (!ring_visible(m, qf, s)) return false;
  return true;
}

// The key tiles a prefill block reads, without a scan over the ring: the
// slots visible to the frame of query row q1 (the tile's newest) hold the
// positions [max(0, end - f_total), offset + frame], which are one run of
// slots modulo f_total, so at most two ascending runs of tiles [lo1, hi1],
// [lo2, hi2] (hi < lo: empty). Of their V tiles, cluster rank `rank` of
// `split` takes the ordinals [rank V / split, (rank + 1) V / split).
__device__ __forceinline__ void ring_tiles(const RingMask& m, int q1, int rank, int& lo1,
                                           int& hi1, int& lo2, int& hi2) {
  lo1 = lo2 = 0;
  hi1 = hi2 = -1;
  const int p_lo = max(0, m.end - m.f_total), p_hi = m.offset + m.by_hw.div(q1);
  if (p_hi < p_lo) return;
  const int cnt = p_hi - p_lo + 1;                    // <= f_total
  const int s_lo = p_lo - m.f_total * m.by_f.div(p_lo);
  auto first = [&](int s) { return (s * m.hw) >> 6; };            // tile of slot s's first row
  auto last = [&](int s) { return ((s + 1) * m.hw - 1) >> 6; };   // and of its last
  if (cnt == m.f_total) {
    lo1 = 0;
    hi1 = last(m.f_total - 1);
  } else if (s_lo + cnt <= m.f_total) {
    lo1 = first(s_lo);
    hi1 = last(s_lo + cnt - 1);
  } else {  // wrapped: slots [0, s_lo + cnt - 1 - f_total] and [s_lo, f_total - 1]
    lo1 = 0;
    hi1 = last(s_lo + cnt - 1 - m.f_total);
    lo2 = first(s_lo);
    hi2 = last(m.f_total - 1);
    if (hi1 >= lo2) {  // one tile holds the end of the first run and the start of the second
      hi1 = hi2;
      hi2 = -1;
    }
  }
  const int len1 = hi1 - lo1 + 1, len2 = max(hi2 - lo2 + 1, 0), v = len1 + len2;
  const int o0 = rank * v / m.split, o1 = (rank + 1) * v / m.split;
  const int b_lo1 = lo1, b_lo2 = lo2;
  lo1 = b_lo1 + o0;
  hi1 = b_lo1 + min(o1, len1) - 1;
  lo2 = b_lo2 + max(o0, len1) - len1;
  hi2 = b_lo2 + o1 - 1 - len1;
  if (hi1 < lo1) lo1 = 0, hi1 = -1;  // an empty run reads as [0, -1]
  if (hi2 < lo2) lo2 = 0, hi2 = -1;
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core path (sm_90a): one warpgroup per 64-row tile.

constexpr int TC_NT = 128;     // threads: one warpgroup
constexpr int NSTAGE = 2;      // ring stages of streamed tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A 64-row bf16 tile of D columns as TMA writes it to shared memory: boxes
// of at most 64 columns (128 bytes a row), each swizzled over its row width
// (32, 64 or 128 bytes: D = 16, 32, 64; D = 128 is two 64-column boxes),
// 1024-byte aligned. The same tile feeds wgmma as a K-major operand (its D
// columns are the reduction: q k^T) or as an MN-major B (its 64 rows are
// the reduction: p v). A wgmma descriptor holds, in 16-byte units, the
// start address (bits 0-13), the leading byte offset LBO (16-29) and the
// stride byte offset SBO (32-45), and the swizzle (bits 62-63: 1 = 128 B,
// 2 = 64 B, 3 = 32 B). Its high word (SBO = 8 rows, the swizzle) is a
// constant of D, so a buffer's descriptor is kept as its 32-bit low word
// and a k-step adds its offset to the start address.
template <int D>
struct TcTile {
  static constexpr int ROWB = D >= 64 ? 128 : 2 * D;  // bytes of a box row
  static constexpr int BOXC = ROWB / 2;               // columns of a box
  static constexpr int BOXES = D / BOXC;
  static constexpr int BOXB = 64 * ROWB;              // bytes of a box
  static constexpr int BYTES = 64 * D * 2;
  static constexpr uint32_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr uint32_t HI = ((8 * ROWB) >> 4) | (LAYOUT << 30);

  __device__ static uint64_t desc(uint32_t lo) { return ((uint64_t)HI << 32) | lo; }
  // As a K-major operand of 64 rows (LBO unused: 1); k-step kk reads
  // columns 16 kk .. 16 kk + 15.
  __device__ static uint32_t klo(uint32_t base) { return ((base & 0x3FFFF) >> 4) | (1u << 16); }
  __host__ __device__ static constexpr uint32_t koff(int kk) {
    return (((kk * 32) / ROWB) * BOXB + (kk * 32) % ROWB) >> 4;
  }
  // As an MN-major B of D columns (the next 64 columns a box away: LBO);
  // k-step kk reads rows 16 kk .. 16 kk + 15.
  __device__ static uint32_t mnlo(uint32_t base) {
    return ((base & 0x3FFFF) >> 4) | ((uint32_t)(BOXB >> 4) << 16);
  }
  __host__ __device__ static constexpr uint32_t mnoff(int kk) { return (kk * 16 * ROWB) >> 4; }
  // The offset of the buffer n tiles further on.
  __host__ __device__ static constexpr uint32_t tiles(int n) { return (uint32_t)(n * BYTES) >> 4; }
};

// The tensor map of a (BH, S, D) bf16 tensor in boxes of 64 rows: 3-D, so a
// box past the end of one head's S rows is zero-filled and never reads the
// next head's.
template <int D>
inline bool tile_map(CUtensorMap* map, const void* ptr, int S, int BH) {
  const CUtensorMapSwizzle sw = TcTile<D>::ROWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : TcTile<D>::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return sm90::make_map_bf16(map, ptr, D, S, BH, TcTile<D>::BOXC, 64, sw);
}

// One thread starts the TMA copy of rows [row0, row0 + 64) of matrix bh.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row0, int bh) {
#pragma unroll
  for (int b = 0; b < TcTile<D>::BOXES; ++b)
    sm90::tma_load_3d(dst + b * TcTile<D>::BOXB, map, bar, b * TcTile<D>::BOXC, row0, bh);
}

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return p + ((1024u - (sm90::smem_u32(p) & 1023u)) & 1023u);
}

// acc = A B^T over D columns: A and B are 64-row tiles (K-major
// descriptor words); the first k-step overwrites acc.
template <int D>
__device__ __forceinline__ void gemm_abt(float (&acc)[32], uint32_t a, uint32_t b) {
  using TT = TcTile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss_n64(acc, TT::desc(a + TT::koff(kk)), TT::desc(b + TT::koff(kk)), kk > 0);
}

// acc += P B: P a 64x64 bf16 matrix in wgmma A fragments, B a 64-row tile
// of D columns (MN-major descriptor word).
template <int D>
__device__ __forceinline__ void gemm_pb(float (&acc)[D / 2], const uint32_t (&p)[16], uint32_t b) {
  using TT = TcTile<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = TT::desc(b + TT::mnoff(kk));
    if constexpr (D == 16) sm90::wgmma_rs_n16(acc, &p[4 * kk], d);
    if constexpr (D == 32) sm90::wgmma_rs_n32(acc, &p[4 * kk], d);
    if constexpr (D == 64) sm90::wgmma_rs_n64(acc, &p[4 * kk], d);
    if constexpr (D == 128) sm90::wgmma_rs_n128(acc, &p[4 * kk], d);
  }
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (x = -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Element i of a thread's m64nN fp32 accumulator sits at row frag_row(i)
// and column frag_col(i) of the tile: a warp holds 16 rows, the quad of
// lanes 4r .. 4r + 3 rows r and r + 8, two neighbouring columns of every 8.
__device__ __forceinline__ int frag_row(int i) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// The accumulator of a 64x64 product as the bf16 A fragments of the next
// product: A's k-step kk holds columns 16 kk .. 16 kk + 15, which are
// accumulator elements 8 kk .. 8 kk + 7 in order, two to a register.
__device__ __forceinline__ void to_a_frags(const float (&x)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * r], x[2 * r + 1]);
    a[r] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Write rows [row0, row0 + 64) of a 64xD fp32 accumulator, times scale[h]
// for the thread's row h, as bf16 into a (rows, D) matrix; rows >= n skip.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[D / 2], int row0, int n,
                                           const float (&scale)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = row0 + frag_row(2 * h);
    if (g >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)g * D + frag_col(i)) =
          __floats2bfloat162_rn(acc[i] * scale[h], acc[i + 1] * scale[h]);
    }
  }
}

// Set the dynamic shared memory limit of a kernel once per instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace adflash
