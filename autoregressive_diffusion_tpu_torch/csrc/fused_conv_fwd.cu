// Train-mode fused gated causal conv, forward, for sm_90a.
//
// Replaces the JAX package's Pallas forward kernel
//   autoregressive_diffusion_tpu/ops/fused_conv.py::fused_gated_conv
//   (_fused_fwd_impl :801, pallas_call :830, body _fwd_kernel :358)
// on torch's channels-last layouts. x (B, F, H, W, C) is the DART concat
// (clean frames [0, T), noisy frames [T, 2T), F = 2T) when with_ctx, or F
// independent frames otherwise:
//   a       = mp_silu(x * cvec)          (each factor optional; fp32, then
//                                         rounded to the working type)
//   y2d[f]  = conv3x3(a[f], w2)
//   ctx[t]  = conv3x3(h[t], w3[0]) + conv3x3(h[t+1], w3[1]),
//             h = [ones, ones, a_clean[0], ..., a_clean[T-2]]
//   out[f]  = (y2d[f] + (ctx[f mod T] - y2d[f]) * g[f]) * rsqrt((1-g)^2 + g^2)
// and, for the backward pass, diff[f] = ctx[f mod T] - y2d[f] (the gate
// gradient needs it; the TPU kernel saves y2d and ctx instead). Without
// with_ctx, out = y2d and nothing else is written. Sums are fp32.
//
// What bounds it on the H100: 72*T*H*W*C*Co operations a batch row against
// (C + 2*Co) elements a pixel, several hundred operations a byte at the
// model's widths, so operations. This first version does not use the
// tensor cores: products are plain fp32 FMAs on an 8x8-pixel x
// 32-channel tile (conv_tile.cuh).
// Why not the TPU kernel's shape: that one walks T in order on one core and
// carries a ring of transformed clean frames in VMEM from step to step.
// Blocks here run in no order, so each block takes one (batch row, time t,
// pixel tile, 32 output channels), reads the two past clean frames itself,
// computes ctx[t] once and serves both the clean frame t and the noisy
// frame T+t with it: four frame convolutions for two output frames.
#include "conv_tile.cuh"

namespace {
using namespace adconv;

template <typename T>
__global__ void __launch_bounds__(CNT)
fused_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w2,
                      const T* __restrict__ w3, const T* __restrict__ cvec,
                      const float* __restrict__ gates, T* __restrict__ out,
                      T* __restrict__ diff, int F, int H, int W, int C, int Co, int silu_in,
                      int with_ctx) {
  __shared__ TileSmem sm;
  const int tiles_x = (W + TS - 1) / TS;
  const int ty0 = (blockIdx.x / tiles_x) * TS, tx0 = (blockIdx.x % tiles_x) * TS;
  const int co0 = blockIdx.y * CO_T;
  const int cg = threadIdx.x & 7, pg = threadIdx.x >> 3;
  const size_t frame = (size_t)H * W * C, oframe = (size_t)H * W * Co;

  if (!with_ctx) {
    const int bf = blockIdx.z;  // b * F + f
    float acc[4][4];
    zero_tile(acc);
    ActLoad<T> ld{x + bf * frame, cvec ? cvec + (size_t)bf * C : nullptr, W, C, silu_in};
    conv_tile<T>(ld, w2, sm, acc, H, W, C, Co, ty0, tx0, co0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = ty0 + pg / TS + 2 * i, xq = tx0 + pg % TS;
      if (y >= H || xq >= W) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int oc = co0 + cg * 4 + j;
        if (oc < Co) out[bf * oframe + ((size_t)y * W + xq) * Co + oc] = from_f<T>(acc[i][j]);
      }
    }
    return;
  }

  const int T_half = F / 2;
  const int b = blockIdx.z / T_half, t = blockIdx.z % T_half;
  const int fc = b * F + t, fn = fc + T_half;  // clean and noisy frame
  float acc_c[4][4], acc_n[4][4], acc_x[4][4];
  zero_tile(acc_c);
  zero_tile(acc_n);
  zero_tile(acc_x);
  {
    ActLoad<T> ld{x + fc * frame, cvec ? cvec + (size_t)fc * C : nullptr, W, C, silu_in};
    conv_tile<T>(ld, w2, sm, acc_c, H, W, C, Co, ty0, tx0, co0);
  }
  {
    ActLoad<T> ld{x + fn * frame, cvec ? cvec + (size_t)fn * C : nullptr, W, C, silu_in};
    conv_tile<T>(ld, w2, sm, acc_n, H, W, C, Co, ty0, tx0, co0);
  }
  for (int k = 0; k < 2; ++k) {  // w3[k] takes clean frame t - 2 + k
    const int tp = t - 2 + k;
    ActLoad<T> ld{nullptr, nullptr, W, C, silu_in};
    if (tp >= 0) {
      ld.frame = x + (size_t)(b * F + tp) * frame;
      ld.cv = cvec ? cvec + (size_t)(b * F + tp) * C : nullptr;
    }
    conv_tile<T>(ld, w3 + (size_t)k * 9 * C * Co, sm, acc_x, H, W, C, Co, ty0, tx0, co0);
  }

  const float g_c = gates[fc], g_n = gates[fn];
  const float r_c = rsqrtf((1.f - g_c) * (1.f - g_c) + g_c * g_c);
  const float r_n = rsqrtf((1.f - g_n) * (1.f - g_n) + g_n * g_n);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int y = ty0 + pg / TS + 2 * i, xq = tx0 + pg % TS;
    if (y >= H || xq >= W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oc = co0 + cg * 4 + j;
      if (oc >= Co) continue;
      const size_t pix = ((size_t)y * W + xq) * Co + oc;
      const float d_c = acc_x[i][j] - acc_c[i][j], d_n = acc_x[i][j] - acc_n[i][j];
      out[fc * oframe + pix] = from_f<T>((acc_c[i][j] + d_c * g_c) * r_c);
      out[fn * oframe + pix] = from_f<T>((acc_n[i][j] + d_n * g_n) * r_n);
      if (diff != nullptr) {
        diff[fc * oframe + pix] = from_f<T>(d_c);
        diff[fn * oframe + pix] = from_f<T>(d_n);
      }
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const void* w2, const void* w3, const void* cvec,
                const float* gates, void* out, void* diff, int B, int F, int H, int W, int C,
                int Co, int silu_in, int with_ctx, cudaStream_t s) {
  const int frames = with_ctx ? B * (F / 2) : B * F;
  dim3 grid(((H + TS - 1) / TS) * ((W + TS - 1) / TS), (Co + CO_T - 1) / CO_T, frames);
  fused_conv_fwd_kernel<T><<<grid, CNT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w2), static_cast<const T*>(w3),
      static_cast<const T*>(cvec), gates, static_cast<T*>(out), static_cast<T*>(diff), F, H, W,
      C, Co, silu_in, with_ctx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. cvec may be null; w3, gates and diff may
// be null when with_ctx = 0; diff may be null when no gradient is wanted.
// Returns a cudaError_t code (0 = success).
int ad_fused_conv_fwd(const void* x, const void* w2, const void* w3, const void* cvec,
                      const float* gates, void* out, void* diff, int B, int F, int H, int W,
                      int C, int Co, int silu_in, int with_ctx, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return (int)cudaErrorInvalidValue;
  if (with_ctx && (F % 2 != 0 || w3 == nullptr || gates == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long frames = with_ctx ? (long long)B * (F / 2) : (long long)B * F;
  if (frames > 65535) return (int)cudaErrorInvalidValue;  // grid.z
  if (dtype == 0)
    return (int)run<float>(x, w2, w3, cvec, gates, out, diff, B, F, H, W, C, Co, silu_in,
                           with_ctx, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, w2, w3, cvec, gates, out, diff, B, F, H, W, C, Co,
                                   silu_in, with_ctx, s);
  return (int)cudaErrorInvalidValue;
}

const char* ad_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
