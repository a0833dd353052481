// Shared pieces of the train-mode fused gated conv kernels
// (fused_conv_fwd.cu, fused_conv_bwd.cu): type helpers, mp_silu and its
// derivative, and the 8x8-pixel x 32-channel 3x3 convolution tile.
//
// The tile is the one of decode_block.cu with the input read through a
// functor, so the same loop serves the forward (transformed activations,
// ones frames) and the backward (gated output gradients, flipped and
// transposed weights): 128 threads, each holding 4 pixels x 4 output
// channels in registers; the input halo tile (10x10 pixels) and the weights
// are staged in shared memory 16 input channels at a time; products are
// plain fp32 FMAs.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace adconv {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to the working type, as fp32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// mp_silu in fp32: sigmoid(z) * z / 0.596, and its derivative
__device__ __forceinline__ float mp_silu(float z) {
  return z / (1.f + expf(-z)) * (1.f / 0.596f);
}
__device__ __forceinline__ float mp_dsilu(float z) {
  const float s = 1.f / (1.f + expf(-z));
  return s * (1.f + z * (1.f - s)) * (1.f / 0.596f);
}

constexpr int TS = 8;         // 8x8 pixel tile
constexpr int HALO = TS + 2;  // with the 1-pixel halo
constexpr int CO_T = 32;      // output channels per block
constexpr int KC = 16;        // input channels staged at a time
constexpr int CNT = 128;      // threads: 16 pixel groups x 8 channel groups

struct TileSmem {
  float in[HALO * HALO][KC + 1];
  __align__(16) float w[9][KC][CO_T];
};

// part[i][j] += sum over taps and the C input channels of
//   load(y, x, c) * w[tap][c][co0 + 4*cg + j]
// for the tile's pixels (ty0 + pg/8 + 2i, tx0 + pg%8). `load` is called for
// in-range (y, x, c) only; everything outside the frame is the conv's zero
// padding. `wsrc` is (9, C, Co) in the working type.
template <typename T, typename Load>
__device__ __forceinline__ void conv_tile(const Load& load, const T* __restrict__ wsrc,
                                          TileSmem& sm, float part[4][4], int H, int W, int C,
                                          int Co, int ty0, int tx0, int co0) {
  const int tid = threadIdx.x;
  const int cg = tid & 7, pg = tid >> 3;
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < HALO * HALO * KC; i += CNT) {
      const int hp = i / KC, ci = i % KC;
      const int y = ty0 - 1 + hp / HALO, xq = tx0 - 1 + hp % HALO, c = c0 + ci;
      float val = 0.f;
      if (y >= 0 && y < H && xq >= 0 && xq < W && c < C) val = load(y, xq, c);
      sm.in[hp][ci] = val;
    }
    for (int i = tid; i < 9 * KC * CO_T; i += CNT) {
      const int tap = i / (KC * CO_T), rem = i % (KC * CO_T);
      const int ci = rem / CO_T, co = rem % CO_T;
      const int c = c0 + ci, oc = co0 + co;
      sm.w[tap][ci][co] = (c < C && oc < Co) ? to_f(wsrc[((size_t)tap * C + c) * Co + oc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll 4
      for (int ci = 0; ci < KC; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(&sm.w[tap][ci][cg * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int py = pg / TS + 2 * i, px = pg % TS;
          const float a = sm.in[(py + dy) * HALO + px + dx][ci];
          part[i][0] += a * wv.x;
          part[i][1] += a * wv.y;
          part[i][2] += a * wv.z;
          part[i][3] += a * wv.w;
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_tile(float part[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
}

// The conv input of the forward pass: a = x * cvec, then mp_silu, rounded to
// the working type; or a ones frame (frame == nullptr), which is 1 inside
// the frame and is not transformed.
template <typename T>
struct ActLoad {
  const T* frame;  // (H, W, C) or nullptr for a ones frame
  const T* cv;     // (C) or nullptr
  int W, C, silu;
  __device__ __forceinline__ float operator()(int y, int x, int c) const {
    if (frame == nullptr) return 1.f;
    float z = to_f(frame[((size_t)y * W + x) * C + c]);
    if (cv != nullptr) z *= to_f(cv[c]);
    if (silu) z = mp_silu(z);
    return round_to<T>(z);
  }
};

}  // namespace adconv
