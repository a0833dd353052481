// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): type helpers, the frame-mask predicate, the
// tile-skipping test and the staging of a 64-row tile in shared memory.
//
// Layout: q, o, dq and dO are (B*H, Sq, D) row-major, k, v, dk and dv
// (B*H, Sk, D); lse and delta are (B*H, Sq) fp32. Sq = Sk but under sequence
// parallelism, where the queries are one seq rank's rows and the keys those
// of all sp ranks (Sk = sp * Sq). A block works on 64 rows with 256 threads,
// four neighbouring lanes of one warp to a row.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace adflash {

constexpr int BQ = 64;   // query rows of a tile
constexpr int BK = 64;   // key rows of a tile
constexpr int NT = 256;  // threads: 4 per row

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The mask: kind 0 = DART over 2 * n_frames frames of hw tokens, 1 = full,
// 2 = frame-causal over n_frames frames. Under sequence parallelism the
// queries are the rows of one seq rank and the keys the rows of all ranks,
// rank-major: t_local is the number of frames a rank holds of each DART
// half (of the causal run) and q_frame0 the gathered frame index of the
// rank's first query frame. Without it, t_local = n_frames and q_frame0 = 0.
struct Mask {
  int kind;
  int n_frames;
  int hw;
  int t_local;
  int q_frame0;
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
  const int span = 2 * m.t_local;
  const int rho = j / span, r = j - rho * span;
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
  return m.kind == 1 || frame_visible<SHARD>(m, qi / m.hw, kj / m.hw);
}

// Whether any query row in [q0, q1] sees any key in [k0, k1] (inclusive,
// inside Sq and Sk), from frame indices alone: exact, since every frame
// pair of the two tiles is tested, wherever the tiles straddle a frame or a
// clean/noisy boundary. Depends only on its arguments, so a whole block
// agrees on it.
template <bool SHARD>
__device__ __forceinline__ bool tile_visible(const Mask& m, int q0, int q1, int k0, int k1) {
  if (m.kind == 1) return true;
  for (int qf = q0 / m.hw; qf <= q1 / m.hw; ++qf)
    for (int kf = k0 / m.hw; kf <= k1 / m.hw; ++kf)
      if (frame_visible<SHARD>(m, qf, kf)) return true;
  return false;
}

// Stage rows [row0, row0 + 64) of a (S, D) matrix as fp32 into dst with a
// padded row stride D + 1 (conflict-free column reads); rows past S are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int row0, int S) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int g = row0 + r;
    dst[r * LD + c] = g < S ? to_f(src[(size_t)g * D + c]) : 0.f;
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
    *m = Mask{kind, n_frames, hw, n_frames, 0};
    return true;
  }
  if (kind == 1 || Sk % Sq != 0) return false;
  const int sp = Sk / Sq;
  const int fq = Sq / hw;  // query frames of the rank
  if (Sq % hw != 0 || sp_rank >= sp) return false;
  if (kind == 0) {
    if (fq % 2 != 0 || n_frames != sp * (fq / 2)) return false;
    *m = Mask{0, n_frames, hw, fq / 2, sp_rank * fq};
  } else {
    if (n_frames != sp * fq) return false;
    *m = Mask{2, n_frames, hw, fq, sp_rank * fq};
  }
  return true;
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
