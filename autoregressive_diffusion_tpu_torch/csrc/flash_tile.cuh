// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): type helpers, the frame-mask predicate, the
// tile-skipping test and the staging of a 64-row tile in shared memory.
//
// Layout: q, k, v, o and their gradients are (B*H, S, D) row-major; lse and
// delta are (B*H, S) fp32. A block works on 64 rows with 256 threads, four
// neighbouring lanes of one warp to a row.
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

// The mask: kind 0 = DART over 2 * n_frames frames of hw tokens, 1 = full.
struct Mask {
  int kind;
  int n_frames;
  int hw;
};

// The rule of ops/masks.py::frame_visible: a clean query frame (qf < T)
// sees frames kf <= qf; a noisy one sees clean frames kf < qf - T and itself.
__device__ __forceinline__ bool frame_visible(const Mask& m, int qf, int kf) {
  if (m.kind == 1) return true;
  if (qf < m.n_frames) return kf <= qf;
  return kf == qf || kf < qf - m.n_frames;
}

__device__ __forceinline__ bool token_visible(const Mask& m, int qi, int kj) {
  return m.kind == 1 || frame_visible(m, qi / m.hw, kj / m.hw);
}

// Whether any query row in [q0, q1] sees any key in [k0, k1] (inclusive,
// both inside S), from frame indices alone. Depends only on its arguments,
// so a whole block agrees on it.
__device__ __forceinline__ bool tile_visible(const Mask& m, int q0, int q1, int k0, int k1) {
  if (m.kind == 1) return true;
  for (int qf = q0 / m.hw; qf <= q1 / m.hw; ++qf)
    for (int kf = k0 / m.hw; kf <= k1 / m.hw; ++kf)
      if (frame_visible(m, qf, kf)) return true;
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
